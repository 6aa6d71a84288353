"""Derived black hole quantities: horizons, ISCO, ergosphere, frame
dragging, time dilation, effective potential, photon sphere, shadow.

PyTorch counterpart of blackhole_tpu.metrics.derived.  Their max, min,
clip and abs follow
JAX's derivative rules (tangent_rules), so torch.func.jvp and
.backward() of them are the JAX package's.
"""

from __future__ import annotations

import math

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


def _cbrt(x):
    """Real cube root (torch has none)."""
    return torch.sign(x) * jabs(x) ** (1.0 / 3.0)


def isco_radius(M, a_over_M, prograde=True):
    """Bardeen-Press-Teukolsky ISCO; 6M at a = 0.  a_over_M: the
    dimensionless spin (its sign ignored; prograde picks the branch)."""
    chi = (torch.where(prograde, a_over_M, -a_over_M)
           if isinstance(prograde, torch.Tensor)
           else a_over_M if prograde else -a_over_M)
    one = torch.ones_like(chi)
    z1 = 1.0 + _cbrt(jmax(1.0 - chi * chi, 0.0)) * (
        _cbrt(one + chi) + _cbrt(one - chi)
    )
    z2 = torch.sqrt(3.0 * chi * chi + z1 * z1)
    inner = jmax((3.0 - z1) * (3.0 + z1 + 2.0 * z2), 0.0)
    sign = torch.where(chi >= 0.0, 1.0, -1.0)
    return M * (3.0 + z2 - sign * torch.sqrt(inner))


def inner_horizon(M, a_over_M, charge=0.0):
    """Inner horizon r- = M - sqrt(M^2 - a^2 - Q^2)."""
    a = a_over_M * M
    return M - torch.sqrt(jmax(M * M - a * a - charge * charge, 0.0))


def ergosphere_radius(theta, M, a_over_M):
    """r_ergo(theta) = M + sqrt(M^2 - a^2 cos^2 theta)."""
    a = a_over_M * M
    ct = torch.cos(theta)
    return M + torch.sqrt(jmax(M * M - a * a * ct * ct, 0.0))


def frame_dragging_omega(r, theta, M, a_over_M):
    """Frame-dragging angular velocity -g_tphi / g_phph
    = 2 M r a / (Sigma (r^2 + a^2) + 2 M r a^2 sin^2)."""
    a = a_over_M * M
    st, ct = torch.sin(theta), torch.cos(theta)
    sigma = r * r + a * a * ct * ct
    denom = sigma * (r * r + a * a) + 2.0 * M * r * a * a * st * st
    return 2.0 * M * r * a / jmax(denom, EPSILON)


def effective_potential(r, l, M, a_over_M=0.0):
    """Effective potential of a massive test particle: at a = 0
    (1 - rs/r)(1 + l^2/r^2) clamped at rs; otherwise the simplified
    equatorial Kerr form clamped at r+."""
    rs = 2.0 * M
    a = a_over_M * M
    r_s = jmax(r, rs + EPSILON)
    schw = (1.0 - rs / r_s) * (1.0 + (l * l) / (r_s * r_s))
    r_plus = M + torch.sqrt(jmax(M * M - a * a, 0.0))
    r_k = jmax(r, r_plus + EPSILON)
    E = 1.0
    kerr = (E * E - 1.0) + (2.0 * M / r_k) * (
        l * l / (r_k * r_k) - 2.0 * M * a * l / (r_k * r_k * r_k)
    )
    return torch.where(torch.as_tensor(a_over_M, device=schw.device) == 0.0,
                       schw, kerr)


def photon_sphere_radius(M, charge=0.0):
    """Photon sphere radius: 3M at Q = 0; Reissner-Nordstrom
    (3M + sqrt(9 M^2 - 8 Q^2)) / 2."""
    disc = torch.sqrt(jmax(9.0 * M * M - 8.0 * charge * charge, 0.0))
    return 0.5 * (3.0 * M + disc)


def rn_critical_impact_parameter(M, charge=0.0):
    """Reissner-Nordstrom critical impact parameter r_ph / sqrt(f(r_ph)),
    f = 1 - 2M/r + Q^2/r^2; sqrt(27) M at Q = 0."""
    r_ph = photon_sphere_radius(M, charge)
    f = 1.0 - 2.0 * M / r_ph + (charge * charge) / (r_ph * r_ph)
    return r_ph / torch.sqrt(jmax(f, EPSILON))


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


def shadow_radius(M, a_over_M=0.0):
    """Apparent shadow (critical impact parameter): sqrt(27) M at a = 0;
    for Kerr the mean of the prograde and retrograde critical equatorial
    impact parameters -(r^3 - 3 M r^2 + a^2 r + a^2 M) / (a (r - M)) at
    the photon-orbit radii."""
    a_over_M = torch.as_tensor(a_over_M, dtype=M.dtype, device=M.device)
    a = a_over_M * M

    def b_crit(rp):
        num = rp * rp * rp - 3.0 * M * rp * rp + a * a * rp + a * a * M
        den = a * (rp - M)
        schw_b = math.sqrt(27.0) * M
        return torch.where(
            jabs(a) < 1e-8,
            schw_b,
            jabs(-num / torch.where(jabs(den) < EPSILON, EPSILON, den)),
        )

    r_pro = kerr_photon_orbit_radius(M, a_over_M, +1.0)
    r_ret = kerr_photon_orbit_radius(M, a_over_M, -1.0)
    return 0.5 * (b_crit(r_pro) + b_crit(r_ret))


def keplerian_orbital_velocity(r, M):
    """Circular-orbit speed v = sqrt(M/r)."""
    return torch.sqrt(M / jmax(r, EPSILON))


def event_horizon(M, a_over_M, charge=0.0):
    """Outer horizon r+ = M + sqrt(M^2 - a^2 - Q^2)."""
    a = a_over_M * M
    return M + torch.sqrt(jmax(M * M - a * a - charge * charge, 0.0))


def hawking_temperature(M):
    """T_H = 1 / (8 pi M) in geometric units."""
    return 1.0 / (8.0 * math.pi * M)


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
