"""Derived black hole quantities used by the render and gradient paths.

PyTorch counterpart of the matching functions of
blackhole_tpu.metrics.derived.  Their max, min, clip and abs follow
JAX's derivative rules (tangent_rules), so torch.func.jvp and
.backward() of them are the JAX package's.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax


def time_dilation(r, M):
    """Schwarzschild time dilation 1/sqrt(1 - rs/r), clamped at the
    horizon."""
    rs = 2.0 * M
    f = jmax(1.0 - rs / jmax(r, rs + EPSILON), EPSILON)
    return 1.0 / torch.sqrt(f)


def kerr_circular_omega(r, M, a, sign=1.0):
    """Coordinate angular velocity of a circular equatorial geodesic:
    Omega = ± M^{1/2} / (r^{3/2} ± a M^{1/2}); sign=+1 prograde."""
    sqM = torch.sqrt(jmax(M, EPSILON))
    r32 = jmax(r, EPSILON) ** 1.5
    return sign * sqM / (r32 + sign * a * sqM)


def static_time_dilation_kerr(r, M, a, charge=0.0):
    """Equatorial static-observer time dilation 1/sqrt(-g_tt), clamped
    at the ergosphere."""
    r = jmax(r, EPSILON)
    f = 1.0 - (2.0 * M * r - charge * charge) / (r * r)
    return 1.0 / torch.sqrt(jmax(f, EPSILON))


def kerr_photon_orbit_radius(M, a_over_M=0.0, sign=1.0):
    """Equatorial circular photon-orbit radius (Bardeen 1972):
    2M (1 + cos(2/3 arccos(-sign a/M))); 3M at a = 0."""
    a_over_M = torch.as_tensor(a_over_M, dtype=M.dtype, device=M.device)
    return 2.0 * M * (
        1.0
        + torch.cos(
            2.0 / 3.0 * torch.arccos(jclip(-sign * a_over_M, -1.0, 1.0))
        )
    )


def keplerian_orbital_velocity(r, M):
    """Circular-orbit speed v = sqrt(M/r)."""
    return torch.sqrt(M / jmax(r, EPSILON))


def event_horizon(M, a_over_M, charge=0.0):
    """Outer horizon r+ = M + sqrt(M^2 - a^2 - Q^2)."""
    a = a_over_M * M
    return M + torch.sqrt(jmax(M * M - a * a - charge * charge, 0.0))


def kerr_radial_potential(r, L, Qc, M, a, charge=0.0):
    """Photon radial potential for E = 1 (Bardeen 1972):
    R(r) = (r^2 + a^2 - a L)^2 - Delta(r) [Qc + (L - a)^2],
    Delta = r^2 - 2 M r + a^2 + e^2; turning points are its roots."""
    delta = r * r - 2.0 * M * r + a * a + charge * charge
    P = r * r + a * a - a * L
    C = Qc + (L - a) * (L - a)
    return P * P - delta * C


def capture_margin_length(L, Qc, M, a, charge=0.0, iters=16):
    """Analytic capture/escape margin of a photon as a signed length:
    sign(R(r*)) sqrt(2 |R(r*)| / R''(r*)), r* the barrier's dip (the
    largest root of R'(r) = 0, by Newton on the depressed cubic from
    above, clamped at 1.01 r+).  Positive: captured; negative: escapes,
    |margin| ~ the periapsis height above the photon shell.  Valid for
    ingoing rays with C = Qc + (L - a)^2 > 0 (trace.compute_capture_
    margin).  The horizon clamp passes charge / M where event_horizon
    takes the charge itself, as the JAX package does."""
    C = Qc + (L - a) * (L - a)
    spin = a / jmax(M, EPSILON)
    r_lo = event_horizon(M, spin, charge / jmax(M, EPSILON)) * 1.01

    # Depressed cubic r^3 + p1 r + q1 for R'/4.
    p1 = (a * a - a * L) - 0.5 * C
    # 1e-12 floor: sqrt'(0) is inf and max's clamped-branch tangent is
    # 0, so an exact-zero radicand turns the jvp into 0 * inf = NaN.
    r = torch.sqrt(jmax(-p1, 1e-12)) + 1.0  # >= largest root; convex

    for _ in range(iters):
        f = r * (r * r + p1) + 0.5 * M * C
        fp = 3.0 * r * r + p1
        r = r - f / torch.where(jabs(fp) < EPSILON, EPSILON, fp)
        r = jmax(r, r_lo)

    R_star = kerr_radial_potential(r, L, Qc, M, a, charge)
    d2 = jmax(12.0 * r * r + 4.0 * p1, EPSILON)
    return torch.sign(R_star) * torch.sqrt(2.0 * jabs(R_star) / d2 + 1e-8)
