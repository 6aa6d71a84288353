"""Forward-mode dual numbers for the plain reference.

A Dual carries a primal tensor v and the tangents d of k directions
beside it, d of shape (k, *v.shape).  Every tangent direction rides one
evaluation of the primal, as the gradient kernel's do.  The functions
below take plain tensors or Duals alike, so one step function serves
the forward reference (plain tensors) and the gradient reference
(Duals).  max, min, clip and abs follow JAX's derivative rules (0.5 of
each operand's tangent at a tie, +1 for abs at 0), which the program
under test documents as its own.
"""

from __future__ import annotations

import torch


class Dual:
    """A primal v and its tangents d (k, *v.shape); d None is zero."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    # arithmetic -------------------------------------------------------
    def __add__(self, o):
        ov, od = parts(o)
        return Dual(self.v + ov, _add(self.d, od))

    __radd__ = __add__

    def __sub__(self, o):
        ov, od = parts(o)
        return Dual(self.v - ov, _add(self.d, None if od is None else -od))

    def __rsub__(self, o):
        ov, od = parts(o)
        return Dual(ov - self.v, _add(od, None if self.d is None
                                      else -self.d))

    def __mul__(self, o):
        ov, od = parts(o)
        return Dual(self.v * ov, _add(_scale(self.d, ov),
                                      _scale(od, self.v)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        ov, od = parts(o)
        v = self.v / ov
        num = _add(self.d, None if od is None else -(od * v))
        return Dual(v, None if num is None else num / ov)

    def __rtruediv__(self, o):
        ov, od = parts(o)
        v = ov / self.v
        num = _add(od, None if self.d is None else -(self.d * v))
        return Dual(v, None if num is None else num / self.v)

    def __neg__(self):
        return Dual(-self.v, None if self.d is None else -self.d)

    def __pow__(self, p: float):
        v = self.v ** p
        return Dual(v, _scale(self.d, p * self.v ** (p - 1.0)))

    # comparisons act on the primal -----------------------------------
    def __lt__(self, o):
        return self.v < value(o)

    def __le__(self, o):
        return self.v <= value(o)

    def __gt__(self, o):
        return self.v > value(o)

    def __ge__(self, o):
        return self.v >= value(o)


def parts(x):
    """(primal, tangent or None) of a Dual, a tensor or a number."""
    if isinstance(x, Dual):
        return x.v, x.d
    return x, None


def value(x):
    return x.v if isinstance(x, Dual) else x


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _scale(d, s):
    """d * s with s broadcast over the tangent axis."""
    return None if d is None else d * s


def _unary(x, f, df):
    """f(x) with tangent df(x.v, f(x.v)) * dx."""
    if not isinstance(x, Dual):
        return f(x)
    v = f(x.v)
    return Dual(v, _scale(x.d, df(x.v, v)))


def sqrt(x):
    return _unary(x, torch.sqrt, lambda _, v: 0.5 / v)


def rsqrt(x):
    return _unary(x, torch.rsqrt, lambda u, v: -0.5 * v / u)


def sin(x):
    return _unary(x, torch.sin, lambda u, _: torch.cos(u))


def cos(x):
    return _unary(x, torch.cos, lambda u, _: -torch.sin(u))


def arccos(x):
    return _unary(x, torch.arccos,
                  lambda u, _: -torch.rsqrt(1.0 - u * u))


def clamp_min(x, lo: float):
    """torch.clamp(x, min=lo): the tangent passes where x >= lo."""
    return _unary(x, lambda u: torch.clamp(u, min=lo),
                  lambda u, _: (u >= lo).to(u.dtype))


def clamp(x, lo: float, hi: float):
    """torch.clamp(x, lo, hi): the tangent passes inside the bounds."""
    return _unary(x, lambda u: torch.clamp(u, lo, hi),
                  lambda u, _: ((u >= lo) & (u <= hi)).to(u.dtype))


def where(c, a, b):
    """torch.where on primal and tangents alike."""
    av, ad = parts(a)
    bv, bd = parts(b)
    v = torch.where(c, av, bv)
    if ad is None and bd is None:
        return v
    if ad is None:
        ad = torch.zeros_like(bd)
    if bd is None:
        bd = torch.zeros_like(ad)
    return Dual(v, torch.where(c, ad, bd))


def _maxmin(a, b, is_max):
    av, ad = parts(a)
    bv, bd = parts(b)
    if isinstance(bv, torch.Tensor):
        r = torch.maximum(av, bv) if is_max else torch.minimum(av, bv)
    else:
        r = torch.clamp(av, min=bv) if is_max else torch.clamp(av, max=bv)
    if ad is None and bd is None:
        return r
    ea, eb = av == r, bv == r
    out = None
    if ad is not None:
        wa = torch.where(ea, torch.where(eb, 0.5, 1.0), 0.0).to(r.dtype)
        out = ad * wa
    if bd is not None:
        wb = torch.where(eb, torch.where(ea, 0.5, 1.0), 0.0).to(r.dtype)
        out = _add(out, bd * wb)
    return Dual(r, out)


def jmax(a, b):
    """jnp.maximum: NaN wins; 0.5 of each tangent at a tie."""
    return _maxmin(a, b, True)


def jmin(a, b):
    return _maxmin(a, b, False)


def jclip(x, lo, hi):
    """jnp.clip: minimum(hi, maximum(lo, x))."""
    return jmin(jmax(x, lo), hi)


def jabs(x):
    """jnp.abs: derivative +1 at 0."""
    return _unary(x, torch.abs,
                  lambda u, _: torch.where(u >= 0.0, 1.0, -1.0).to(u.dtype))


def isfinite(x):
    return torch.isfinite(value(x))


def take(x, idx):
    """x at the rays idx (a bool mask or an index tensor)."""
    if isinstance(x, Dual):
        return Dual(x.v[idx], None if x.d is None else x.d[:, idx])
    return x[idx]


def cat(xs):
    """Concatenate per-ray tensors or Duals along the ray axis."""
    if isinstance(xs[0], Dual):
        return Dual(torch.cat([x.v for x in xs]),
                    torch.cat([x.d for x in xs], dim=1))
    return torch.cat(xs)
