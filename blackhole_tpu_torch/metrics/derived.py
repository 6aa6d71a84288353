"""Derived black hole quantities used by the forward render path.

PyTorch counterpart of the matching functions of
blackhole_tpu.metrics.derived.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import EPSILON


def time_dilation(r, M):
    """Schwarzschild time dilation 1/sqrt(1 - rs/r), clamped at the
    horizon."""
    rs = 2.0 * M
    f = torch.clamp(
        1.0 - rs / torch.maximum(r, rs + EPSILON), min=EPSILON
    )
    return 1.0 / torch.sqrt(f)


def kerr_circular_omega(r, M, a, sign=1.0):
    """Coordinate angular velocity of a circular equatorial geodesic:
    Omega = ± M^{1/2} / (r^{3/2} ± a M^{1/2}); sign=+1 prograde."""
    sqM = torch.sqrt(torch.clamp(M, min=EPSILON))
    r32 = torch.clamp(r, min=EPSILON) ** 1.5
    return sign * sqM / (r32 + sign * a * sqM)


def static_time_dilation_kerr(r, M, a, charge=0.0):
    """Equatorial static-observer time dilation 1/sqrt(-g_tt), clamped
    at the ergosphere."""
    r = torch.clamp(r, min=EPSILON)
    f = 1.0 - (2.0 * M * r - charge * charge) / (r * r)
    return 1.0 / torch.sqrt(torch.clamp(f, min=EPSILON))


def kerr_photon_orbit_radius(M, a_over_M=0.0, sign=1.0):
    """Equatorial circular photon-orbit radius (Bardeen 1972):
    2M (1 + cos(2/3 arccos(-sign a/M))); 3M at a = 0."""
    a_over_M = torch.as_tensor(a_over_M, dtype=M.dtype, device=M.device)
    return 2.0 * M * (
        1.0
        + torch.cos(
            2.0 / 3.0 * torch.arccos(torch.clamp(-sign * a_over_M, -1.0, 1.0))
        )
    )


def keplerian_orbital_velocity(r, M):
    """Circular-orbit speed v = sqrt(M/r)."""
    return torch.sqrt(M / torch.clamp(r, min=EPSILON))
