"""Tangent and cotangent guards for chaotic geodesic integration.

PyTorch counterpart of blackhole_tpu.integrate.sensitivity.  Near the
photon shell forward-mode sensitivities grow like e^(lambda * steps)
and overflow float32 within the step budget, and so do reverse-mode
adjoints.  The primal stays exact; only the per-ray tangent (or
cotangent) vector is guarded, once per integration step:

* magnitude above TANGENT_LIMIT -> rescaled to TANGENT_LIMIT
  (direction kept; the identity below the limit),
* non-finite                    -> zeroed for good.

`tangent_guard` is an identity on the primal whose tangent under
torch.func.jvp is guarded; like the JAX package's custom_jvp it has no
reverse-mode rule (jax.grad through it raises too).  `cotangent_guard`
is its reverse-mode twin: an identity whose cotangent is guarded in
.backward(), placed before every step of the reverse-mode trace
(grad.diff_trace).  Neither changes a value that is not differentiated.
"""

from __future__ import annotations

import torch

# Per-ray tangent magnitude cap (the JAX package's value and rationale).
TANGENT_LIMIT = 1.0e6


def _guard_tree(dx, ray_ndim: int):
    """Rescale a sequence of per-ray tangents so each ray's magnitude is
    at most TANGENT_LIMIT.

    ray_ndim: number of leading axes that index rays (shared by every
    leaf); trailing axes are per-ray components and are reduced.  A None
    leaf is a zero tangent and stays None.  Per ray: mag is the
    NaN-propagating max of |d| over every slot, factor is LIMIT /
    max(mag, LIMIT), or 0 where mag is not finite, and each leaf becomes
    where(isfinite(d), d, 0) * factor."""
    mag = None
    for leaf in dx:
        if leaf is None:
            continue
        a = torch.abs(leaf)
        for _ in range(a.dim() - ray_ndim):
            a = torch.amax(a, dim=-1)
        # torch.maximum propagates NaN, as jnp.maximum does.
        mag = a if mag is None else torch.maximum(mag, a)
    if mag is None:
        return tuple(dx)
    # A true division (a Python float over a tensor would be reciprocal
    # times the float, which rounds otherwise).
    factor = torch.full_like(mag, TANGENT_LIMIT) / torch.clamp(
        mag, min=TANGENT_LIMIT)
    factor = torch.where(torch.isfinite(mag), factor, 0.0)

    def apply(leaf):
        if leaf is None:
            return None
        f = factor.reshape(factor.shape + (1,) * (leaf.dim() - ray_ndim))
        # Scrub before scaling: factor 0 alone leaves nan (nan * 0).
        return torch.where(torch.isfinite(leaf), leaf, 0.0) * f

    return tuple(apply(leaf) for leaf in dx)


class _TangentGuard(torch.autograd.Function):
    """Identity on the primal tuple; guards its tangent."""

    @staticmethod
    def forward(ray_ndim, *tree):
        return tuple(t.view_as(t) for t in tree)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ray_ndim = inputs[0]

    @staticmethod
    def jvp(ctx, _dndim, *dtree):
        return _guard_tree(dtree, ctx.ray_ndim)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "tangent_guard is forward-mode only, as in the JAX package; "
            "reverse mode guards with cotangent_guard (grad.diff_trace)"
        )


def tangent_guard(ray_ndim: int, tree):
    """Identity on a tuple of per-ray tensors; under torch.func.jvp its
    tangent is guarded (_guard_tree).  Returns a tuple."""
    return tuple(_TangentGuard.apply(ray_ndim, *tree))


class _CotangentGuard(torch.autograd.Function):
    """Identity on the primal tuple; guards its cotangent."""

    @staticmethod
    def forward(ray_ndim, *tree):
        return tuple(t.view_as(t) for t in tree)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ray_ndim = inputs[0]
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + _guard_tree(grads, ctx.ray_ndim)


def cotangent_guard(ray_ndim: int, tree):
    """Identity on a tuple of per-ray tensors; the cotangent flowing
    back through it is guarded per ray (_guard_tree: rescaled to
    TANGENT_LIMIT, non-finite values zeroed).  Reverse mode only.
    Returns a tuple."""
    return tuple(_CotangentGuard.apply(ray_ndim, *tree))
