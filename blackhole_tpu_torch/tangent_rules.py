"""max, min, clip and abs with the JAX package's tangent rules.

Their primal is torch.maximum / minimum / clamp / abs, but torch's
forward-mode derivatives differ from jax.jvp's where the JAX package
relies on them: jnp.maximum/minimum give 0.5 (da + db) at a tie and a
zero tangent where the result is NaN (torch: db + w (da - db), which
rounds and keeps db at NaN), jnp.clip is minimum(hi, maximum(lo, x))
(torch.clamp passes the whole tangent at a bound), and jnp.abs has
tangent +dx at 0 (torch.abs: 0).  A bound given as a Python float is a
constant without tangent.  The geodesic step (render.trace_kernel) and
the capture margin (metrics.derived) take them, so torch.func.jvp of
either is jax.jvp's tangent.
"""

from __future__ import annotations

import torch


class _MaxMin(torch.autograd.Function):
    @staticmethod
    def forward(a, b, is_max):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b) if is_max else torch.minimum(a, b)
        return torch.clamp(a, min=b) if is_max else torch.clamp(a, max=b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, _ = inputs
        ctx.b = None if isinstance(b, torch.Tensor) else b
        if ctx.b is None:
            ctx.save_for_forward(a, output, b)
        else:
            ctx.save_for_forward(a, output)

    @staticmethod
    def jvp(ctx, da, db, _):
        a, r, *rest = ctx.saved_tensors
        b = rest[0] if rest else ctx.b
        ea, eb = a == r, b == r
        out = None
        if da is not None:
            out = da * torch.where(ea, torch.where(eb, 0.5, 1.0), 0.0)
        if db is not None:
            t = db * torch.where(eb, torch.where(ea, 0.5, 1.0), 0.0)
            out = t if out is None else out + t
        return out


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.abs(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, dx, -dx)


def jmax(a, b):
    """jnp.maximum: NaN wins; tangent rule as in jax.jvp."""
    return _MaxMin.apply(a, b, True)


def jmin(a, b):
    """jnp.minimum: NaN wins; tangent rule as in jax.jvp."""
    return _MaxMin.apply(a, b, False)


def jclip(x, lo, hi):
    """jnp.clip: minimum(hi, maximum(lo, x))."""
    return jmin(jmax(x, lo), hi)


def jabs(x):
    """jnp.abs: tangent +dx at 0."""
    return _Abs.apply(x)
