"""Coordinate transforms: cartesian <-> spherical <-> Boyer-Lindquist.

PyTorch counterpart of blackhole_tpu.geom.coords.  Broadcast over
leading batch dims; their max and clip follow JAX's derivative rules
(tangent_rules), so torch.func.jvp of them is the JAX package's.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import EPSILON, TWO_PI
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax


def cartesian_to_spherical(xyz):
    """(x, y, z) -> (r, theta, phi) with phi in [0, 2pi), guarded at the
    origin and the poles.  xyz: (..., 3) -> (..., 3)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(jclip(z / jmax(r, EPSILON), -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return torch.stack([r, theta, phi], dim=-1)


def spherical_to_cartesian(sph):
    """(r, theta, phi) -> (x, y, z)."""
    r, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([r * st * cp, r * st * sp, r * ct], dim=-1)


def spherical_direction_from_cartesian(sph, dxyz):
    """Coordinate velocities (dr, dtheta, dphi) of a cartesian direction
    dxyz at the point sph = (r, theta, phi): the inverse Jacobian's
    rows, dphi set to 0 at the poles."""
    r, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    dx, dy, dz = dxyz[..., 0], dxyz[..., 1], dxyz[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    safe_r = jmax(r, EPSILON)
    dr = st * cp * dx + st * sp * dy + ct * dz
    dtheta = (ct * cp * dx + ct * sp * dy - st * dz) / safe_r
    pole = jabs(st) < EPSILON
    st_safe = torch.where(pole, 1.0, st)
    dphi = torch.where(pole, 0.0, (-sp * dx + cp * dy) / (safe_r * st_safe))
    return torch.stack([dr, dtheta, dphi], dim=-1)


def cartesian_direction_from_spherical(sph, dsph):
    """Jacobian push-forward: (dr, dtheta, dphi) -> (dx, dy, dz)."""
    r, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    dr, dth, dph = dsph[..., 0], dsph[..., 1], dsph[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    dx = st * cp * dr + r * ct * cp * dth - r * st * sp * dph
    dy = st * sp * dr + r * ct * sp * dth + r * st * cp * dph
    dz = ct * dr - r * st * dth
    return torch.stack([dx, dy, dz], dim=-1)


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


def boyer_lindquist_to_cartesian(bl, a):
    """Boyer-Lindquist (r, theta, phi) -> cartesian:
    x = sqrt(r^2 + a^2) sin(theta) cos(phi), ..., z = r cos(theta)."""
    r, theta, phi = bl[..., 0], bl[..., 1], bl[..., 2]
    w = torch.sqrt(r * r + a * a)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack(
        [w * st * torch.cos(phi), w * st * torch.sin(phi), r * ct], dim=-1
    )


def normalize(v, axis=-1):
    """Unit vector with a zero-safe guard."""
    n = torch.linalg.vector_norm(v, dim=axis, keepdim=True)
    return torch.where(
        n < EPSILON, torch.zeros_like(v), v / torch.clamp(n, min=EPSILON)
    )
