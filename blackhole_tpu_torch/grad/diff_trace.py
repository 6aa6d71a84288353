"""Differentiable geodesic tracing: reverse mode through the integrator.

PyTorch counterpart of blackhole_tpu.grad.diff_trace.  The forward
engine (render.trace.trace_rays) stops when every ray is done and has
no reverse-mode rule; this module re-drives the same trace_step for a
fixed number of masked steps under two-level checkpointing: the steps
run in segments of `inner` steps, each segment one _Segment node whose
forward keeps only the carry it returns and whose backward recomputes
the segment's graph and differentiates it, so the forward keeps one
carry per segment and the backward one segment's graph at a time
(O(sqrt(max_steps)) carries instead of O(max_steps)).  A cotangent
guard precedes every step.
"""

from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.integrate import sensitivity
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import trace

_FIELDS = tuple(f for f in trace.TraceCarry._fields if f != "iter")


class _PerRay(torch.autograd.Function):
    """A scene scalar broadcast to one value per ray.  Backward sums the
    rays' cotangents with the non-finite ones zeroed.  A ray that does
    not advance still runs the trial step, whose stages can overflow
    (a frozen lane near the horizon), and the zero cotangent the mask
    sends there meets an infinite partial derivative, 0 * inf = NaN.
    The carry's guard zeroes such a ray's state cotangent; this zeroes
    its share of the scene's, which would otherwise make the whole
    gradient NaN.  Where every ray's share is finite it is the plain
    sum, so the gradient is the JAX package's."""

    @staticmethod
    def forward(x, n):
        return x.expand(n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape = inputs[0].shape

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isfinite(g), g, 0.0)
        return g.sum_to_size(ctx.shape), None


def _per_ray(scene: Scene, n: int) -> Scene:
    """scene with each scalar (or per-ray) leaf that requires grad
    broadcast per ray (_PerRay): the same values, the same bits."""
    leaves, spec = pytree.tree_flatten(scene)
    return pytree.tree_unflatten(
        [_PerRay.apply(t, n) if t.requires_grad and t.dim() <= 1 else t
         for t in leaves], spec)


def _run(scene: Scene, n: int, flat):
    """n guarded steps from the flattened carry; returns it flattened."""
    c = trace.TraceCarry(**dict(zip(_FIELDS, flat)), iter=0)
    step_fn, adaptive = trace.make_step_fn(scene)
    for _ in range(n):
        # Identity forward; in the backward sweep each ray's cotangent
        # is rescaled to TANGENT_LIMIT and non-finite values zeroed.
        c = trace.guard_carry(c, sensitivity.cotangent_guard)
        c = trace.trace_step(c, scene, step_fn, adaptive)
    return tuple(getattr(c, f) for f in _FIELDS)


class _Segment(torch.autograd.Function):
    """n steps as one checkpointed node: forward without a graph;
    backward recomputes the steps from the saved input carry and the
    scene's tensors (passed as inputs, so their gradients come back
    like the carry's) and differentiates them.  This is
    torch.utils.checkpoint's rule with the recompute's graph built only
    in the backward: its saved-tensor hooks cost as much as the steps
    themselves in eager mode (the measurement is in PERF.md)."""

    @staticmethod
    def forward(ctx, spec, n, n_carry, *tensors):
        ctx.spec, ctx.n, ctx.n_carry = spec, n, n_carry
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        flat, leaves = tensors[:n_carry], tensors[n_carry:]
        with torch.no_grad():
            out = _Segment._steps(spec, n, flat, leaves)
        ctx.mark_non_differentiable(*(t for t in out
                                      if not t.is_floating_point()))
        return out

    @staticmethod
    def _steps(spec, n, flat, leaves):
        scene_spec, none_at = spec
        scene = pytree.tree_unflatten(list(leaves), scene_spec)
        flat = list(flat)
        for i in none_at:
            flat.insert(i, None)
        out = _run(scene, n, flat)
        return tuple(t for t in out if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(t.requires_grad
                                            and t.is_floating_point())
                  for t in saved]
        with torch.enable_grad():
            out = _Segment._steps(ctx.spec, ctx.n, inputs[:ctx.n_carry],
                                  inputs[ctx.n_carry:])
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else ())
        return (None, None, None) + tuple(
            next(got) if t.requires_grad else None for t in inputs)


def trace_rays_diff(origins, directions, scene: Scene, segments: int = 0):
    """Differentiable equivalent of trace.trace_rays.

    Runs exactly n_seg * inner + remainder = max_steps masked steps (no
    early exit).  segments: the number of checkpointed segments; 0 ->
    round(sqrt(max_steps)).  Frozen rays take the extra steps with
    their state held (renormalize_trig moves their trig at ulp level),
    so the forward equals trace_rays to rounding."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    carry0 = trace.init_carry(o, d, scene)
    max_steps = scene.config.max_steps
    n_seg = segments or max(1, int(round(math.sqrt(max_steps))))
    inner = max_steps // n_seg
    remainder = max_steps - n_seg * inner

    flat = [getattr(carry0, f) for f in _FIELDS]
    none_at = tuple(i for i, t in enumerate(flat) if t is None)
    # The steps see the scene per ray.  A ray's share of the scene's
    # cotangent that is not finite is an artefact of a trial step it
    # did not take: the carry's guard has zeroed its earlier steps', and
    # its later steps are frozen, so zeroing the whole share loses
    # nothing else.
    leaves, scene_spec = pytree.tree_flatten(_per_ray(scene, o.shape[0]))
    spec = (scene_spec, none_at)
    carry_t = tuple(t for t in flat if t is not None)
    runs = [inner] * (n_seg if inner > 0 else 0)
    runs += [remainder] if remainder > 0 else []
    for n in runs:
        carry_t = _Segment.apply(spec, n, len(carry_t), *carry_t, *leaves)
    flat = list(carry_t)
    for i in none_at:
        flat.insert(i, None)
    carry = trace.TraceCarry(**dict(zip(_FIELDS, flat)), iter=max_steps)
    margin = (trace.compute_capture_margin(o, d, scene)
              if float(scene.config.shadow_softness) > 0.0 else None)
    hit = trace.finalize(carry, scene, margin=margin)
    return hit.map(lambda x: x.reshape(tuple(batch_shape) + x.shape[1:]))


def render_image_diff(scene: Scene, camera: Camera, width: int = 64,
                      height: int = 64, segments: int = 0):
    """Differentiable render: RGB (H, W, 3) as a function of the scene's
    and the camera's tensors (single sample, no jitter)."""
    origins, dirs = cam.generate_rays(camera, width, height)
    hit = trace_rays_diff(origins.reshape(-1, 3), dirs.reshape(-1, 3), scene,
                          segments)
    return hit.color.reshape(height, width, 3)
