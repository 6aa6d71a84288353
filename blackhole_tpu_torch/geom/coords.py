"""Coordinate transforms (the forward path's subset).

PyTorch counterpart of blackhole_tpu.geom.coords: normalize and the
exact cartesian -> Boyer-Lindquist map.  Broadcast over leading batch
dims.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import EPSILON, TWO_PI


def cartesian_to_boyer_lindquist(xyz, a):
    """Exact cartesian -> Boyer-Lindquist (r, theta, phi) for spin a.

    r^2 = 0.5 (rho^2 - a^2) + sqrt(0.25 (rho^2 - a^2)^2 + a^2 z^2) with
    rho^2 = x^2 + y^2 + z^2; reduces to spherical for a = 0.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rho2 = x * x + y * y + z * z
    half = 0.5 * (rho2 - a * a)
    r2 = half + torch.sqrt(half * half + a * a * z * z)
    r = torch.sqrt(torch.clamp(r2, min=EPSILON))
    theta = torch.arccos(
        torch.clamp(z / torch.clamp(r, min=EPSILON), -1.0, 1.0)
    )
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return torch.stack([r, theta, phi], dim=-1)


def normalize(v, axis=-1):
    """Unit vector with a zero-safe guard."""
    n = torch.linalg.vector_norm(v, dim=axis, keepdim=True)
    return torch.where(
        n < EPSILON, torch.zeros_like(v), v / torch.clamp(n, min=EPSILON)
    )
