"""Few-parameter gradients by forward mode through the geodesic kernel.

PyTorch counterpart of blackhole_tpu.grad.fast_grad.  Forward mode
propagates one tangent per parameter inside the kernel: full per-ray
early exit, no rematerialisation.  scene_value_and_grad and
render_value_and_grad carry every tangent through ONE pass of the
multi-tangent kernel K2 (render.trace_kernel.trace_rays_kernel_fwdgrad);
value_and_grad_fwd takes one torch.func.jvp per parameter, each of
which reaches K2 with one tangent (K3) through the planes pass's
forward-mode rule.

Parameters are a dict (or any torch pytree) of 0-d or small tensors;
every component is one tangent direction.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
from torch.func import jvp
from torch.utils import _pytree as pytree

from blackhole_tpu_torch.render import trace_kernel
from blackhole_tpu_torch.utils import profiling

# Per-component winsorisation of colour tangents: near-critical rays'
# pathwise tangents are finite (the tangent guard caps them) but carry
# no usable signal; the JAX package chose 15 against per-pixel finite
# differences (its fast_grad.TANGENT_CLIP).  None: the raw estimator.
TANGENT_CLIP = 15.0


def _clip_hit_tangent(dhit, clip):
    if clip is None:
        return dhit
    return dataclasses.replace(dhit, color=torch.clamp(dhit.color, -clip,
                                                       clip))


class _ClipTangent(torch.autograd.Function):
    """Identity on the primal colour; clips its tangent to [-clip, clip]."""

    @staticmethod
    def forward(color, clip):
        return color.view_as(color)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.clip = inputs[1]

    @staticmethod
    def jvp(ctx, dcolor, _):
        return torch.clamp(dcolor, -ctx.clip, ctx.clip)


def clip_color_tangent(hit, clip=TANGENT_CLIP):
    """Identity on the primal Hit; under torch.func.jvp its colour
    tangent is winsorised (the estimator scene_value_and_grad and
    render_value_and_grad apply).  Put it between the trace and the loss
    when differentiating with value_and_grad_fwd.  clip=None is the raw
    estimator."""
    if clip is None:
        return hit
    return dataclasses.replace(hit, color=_ClipTangent.apply(hit.color,
                                                             float(clip)))


def _flatten_scalars(params):
    """Flatten a pytree into a list of 0-d tensors.

    Returns (values, rebuild), rebuild(list) -> pytree.  Tensor leaves
    are split per component, so every tangent direction is one scalar."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    values = []
    for leaf in leaves:
        values.extend(v.clone() for v in leaf.reshape(-1).unbind())

    def rebuild(vals):
        out, k = [], 0
        for leaf in leaves:
            size = leaf.numel()
            out.append(torch.stack(
                [torch.as_tensor(v, dtype=leaf.dtype) for v in vals[k:k + size]]
            ).reshape(leaf.shape))
            k += size
        return pytree.tree_unflatten(out, spec)

    return values, rebuild


def _basis(values, i):
    return [torch.ones_like(v) if j == i else torch.zeros_like(v)
            for j, v in enumerate(values)]


def _build_and_tangents(build, values):
    """build(values) and its tangent along each scalar direction."""
    return build(values), [jvp(build, (values,), (_basis(values, i),))[1]
                           for i in range(len(values))]


def _loss_jvp(loss_of_hit, hit, dhit):
    """torch.func.jvp of loss_of_hit at hit along dhit.  The integer
    fields (result, steps) have no tangent and are held fixed."""
    names = [f.name for f in dataclasses.fields(hit)
             if getattr(hit, f.name).is_floating_point()]

    def f(*floats):
        return loss_of_hit(dataclasses.replace(hit, **dict(zip(names,
                                                               floats))))

    return jvp(f, tuple(getattr(hit, k) for k in names),
               tuple(getattr(dhit, k) for k in names))


def _losses(loss_of_hit, hit, dhits, tangent_clip, rebuild):
    loss, grads = None, []
    for dhit in dhits:
        loss, dl = _loss_jvp(loss_of_hit, hit,
                             _clip_hit_tangent(dhit, tangent_clip))
        grads.append(dl)
    if loss is None:
        loss = loss_of_hit(hit)
    return loss, rebuild(grads)


def value_and_grad_fwd(fun):
    """Forward-mode value_and_grad for functions of few scalars.

    fun(params, *args) -> scalar loss.  Returns g(params, *args) ->
    (loss, grads) from one torch.func.jvp per scalar component of
    params; each runs the kernel with one tangent (K3) when fun renders
    through trace_kernel.trace_rays_kernel / image.trace_rays_fast.  For
    the clipped estimator of scene_value_and_grad, apply
    clip_color_tangent to the Hit inside fun."""

    def value_and_grad(params, *args):
        values, rebuild = _flatten_scalars(params)

        def f_flat(vals):
            return fun(rebuild(vals), *args)

        loss, grads = None, []
        for i in range(len(values)):
            loss, dv = jvp(f_flat, (values,), (_basis(values, i),))
            grads.append(dv)
        return loss, rebuild(grads)

    return value_and_grad


def render_value_and_grad(loss_of_hit, setup_fn, tangent_clip=TANGENT_CLIP):
    """Forward-mode value_and_grad when the rays depend on the params.

    setup_fn(params) -> (scene, origins, dirs): ray generation is part of
    the differentiated function, so camera pose and fov gradients flow,
    all through ONE pass of K2.  Returns g(params, order=None) ->
    (loss, grads)."""

    calls = itertools.count()

    def value_and_grad(params, order=None):
        with profiling.span("grad.value_and_grad", next(calls)):
            values, rebuild = _flatten_scalars(params)

            def build(vals):
                return setup_fn(rebuild(vals))

            (scene, origins, dirs), tangents = _build_and_tangents(build,
                                                                   values)
            hit, dhits = trace_kernel.trace_rays_kernel_fwdgrad(
                origins, dirs, scene, tangents, order=order)
            return _losses(loss_of_hit, hit, dhits, tangent_clip, rebuild)

    return value_and_grad


def scene_value_and_grad(loss_of_hit, scene_fn, tangent_clip=TANGENT_CLIP):
    """Forward-mode value_and_grad through ONE pass of K2.

    scene_fn(params) -> Scene; loss_of_hit(hit) -> scalar.  Returns
    g(params, origins, dirs, order=None) -> (loss, grads).  Where
    value_and_grad_fwd runs the kernel once per parameter (cost
    n (P + T)), this carries all n tangents beside one primal (P + n T):
    the fast path for the bench's (mass, spin) gradient."""

    calls = itertools.count()

    def value_and_grad(params, origins, dirs, order=None):
        with profiling.span("grad.value_and_grad", next(calls)):
            values, rebuild = _flatten_scalars(params)

            def build(vals):
                return scene_fn(rebuild(vals))

            scene, tangents = _build_and_tangents(build, values)
            hit, dhits = trace_kernel.trace_rays_kernel_fwdgrad(
                origins, dirs, scene, tangents, order=order)
            return _losses(loss_of_hit, hit, dhits, tangent_clip, rebuild)

    return value_and_grad
