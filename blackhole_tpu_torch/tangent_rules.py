"""max, min, clip and abs with the JAX package's derivative rules.

Their primal is torch.maximum / minimum / clamp / abs, but torch's
derivatives differ from JAX's where the JAX package relies on them:
jnp.maximum/minimum give 0.5 (da + db) at a tie and a zero tangent
where the result is NaN (torch: db + w (da - db), which rounds and
keeps db at NaN), jnp.clip is minimum(hi, maximum(lo, x)) (torch.clamp
passes the whole derivative at a bound), and jnp.abs has derivative +1
at 0 (torch.abs: 0).  jax.grad transposes these linear rules, so the
reverse-mode weights are the forward ones: a cotangent g of max(a, b)
sends g w_a to a and g w_b to b.  A bound given as a Python float is a
constant without derivative.  The geodesic step (render.trace_kernel,
render.trace), the shading and the capture margin (metrics.derived)
take them, so torch.func.jvp and .backward() of either follow jax.jvp
and jax.grad.
"""

from __future__ import annotations

import torch


def _weights(a, b, r):
    """(w_a, w_b) of max/min(a, b) = r: 1 for the operand that equals
    the result, 0.5 each at a tie, 0 where the result is NaN."""
    ea, eb = a == r, b == r
    return (torch.where(ea, torch.where(eb, 0.5, 1.0), 0.0),
            torch.where(eb, torch.where(ea, 0.5, 1.0), 0.0))


def _unbroadcast(g, like):
    """Sum a broadcast cotangent g back to the shape of `like`."""
    if g.shape == like.shape:
        return g
    lead = g.dim() - like.dim()
    if lead > 0:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(like.shape) if n == 1
                 and g.shape[i] != 1)
    if dims:
        g = g.sum(dim=dims, keepdim=True)
    return g


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
        saved = (a, output) if ctx.b is not None else (a, output, b)
        ctx.save_for_forward(*saved)
        ctx.save_for_backward(*saved)

    @staticmethod
    def jvp(ctx, da, db, _):
        a, r, *rest = ctx.saved_tensors
        wa, wb = _weights(a, rest[0] if rest else ctx.b, r)
        out = None
        if da is not None:
            out = da * wa
        if db is not None:
            t = db * wb
            out = t if out is None else out + t
        return out

    @staticmethod
    def backward(ctx, g):
        a, r, *rest = ctx.saved_tensors
        b = rest[0] if rest else ctx.b
        wa, wb = _weights(a, b, r)
        ga = (_unbroadcast(g * wa, a) if ctx.needs_input_grad[0]
              else None)
        gb = (_unbroadcast(g * wb, b) if rest and ctx.needs_input_grad[1]
              else None)
        return ga, gb, None


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.abs(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, dx, -dx)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, g, -g)


def jmax(a, b):
    """jnp.maximum: NaN wins; derivative rules as in JAX."""
    return _MaxMin.apply(a, b, True)


def jmin(a, b):
    """jnp.minimum: NaN wins; derivative rules as in JAX."""
    return _MaxMin.apply(a, b, False)


def jclip(x, lo, hi):
    """jnp.clip: minimum(hi, maximum(lo, x))."""
    return jmin(jmax(x, lo), hi)


def jabs(x):
    """jnp.abs: derivative +1 at 0."""
    return _Abs.apply(x)
