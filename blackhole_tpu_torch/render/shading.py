"""Disk temperature, blackbody colour and relativistic shading.

PyTorch counterpart of blackhole_tpu.render.shading (the forward path's
subset).  Branch-free over rays, batched over leading dims.
"""

from __future__ import annotations

import logging
import math

import torch

from blackhole_tpu_torch.constants import (
    DISK_TEMP_BASE_K,
    DISK_TEMP_RANGE_K,
    EPSILON,
    MAX_TEMP_K,
    MIN_TEMP_K,
)
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.metrics import derived

log = logging.getLogger(__name__)


def temperature_to_rgb(temperature):
    """Piecewise blackbody temperature -> RGB; (...,) K -> (..., 3)."""
    t = (torch.clamp(temperature, MIN_TEMP_K, MAX_TEMP_K) - MIN_TEMP_K) / (
        MAX_TEMP_K - MIN_TEMP_K
    )
    r = torch.where(t < 0.5, t * 2.0, 1.0)
    g = torch.where(
        t < 0.25, 0.0, torch.where(t < 0.75, (t - 0.25) * 2.0, 1.0)
    )
    b = torch.where(t < 0.5, 0.0, (t - 0.5) * 2.0)
    brightness = 0.2 + 0.8 * t * t
    return torch.stack([r, g, b], dim=-1) * brightness[..., None]


def disk_temperature(r_hit, disk_inner, disk_outer, temp_scale):
    """Thin-disk profile T = scale (2000 + 18000 (1 - r_norm)^0.75) K."""
    rn = torch.clamp(
        (r_hit - disk_inner) / torch.clamp(disk_outer - disk_inner,
                                           min=EPSILON),
        0.0,
        1.0,
    )
    temp_factor = torch.clamp(1.0 - rn, min=1e-9) ** 0.75
    return temp_scale * (DISK_TEMP_BASE_K + DISK_TEMP_RANGE_K * temp_factor)


def doppler_factor_relativistic(hit_pos, photon_dir, M):
    """Special-relativistic Doppler factor of Keplerian disk flow:
    sqrt((1 - beta cos a)/(1 + beta cos a)), beta = sqrt(M/r)."""
    x, y = hit_pos[..., 0], hit_pos[..., 1]
    r = torch.sqrt(x * x + y * y)
    beta = torch.clamp(
        derived.keplerian_orbital_velocity(r, M), 0.0, 1.0 - 1e-6
    )
    tangent = torch.stack(
        [-y, x, torch.zeros_like(x)], dim=-1
    ) / torch.clamp(r, min=EPSILON)[..., None]
    d = coords.normalize(photon_dir)
    cos_angle = torch.sum(d * tangent, dim=-1)
    return torch.sqrt(
        torch.clamp(1.0 - beta * cos_angle, min=EPSILON)
        / torch.clamp(1.0 + beta * cos_angle, min=EPSILON)
    )


def kerr_g_factor(r_bl, L, M, a, charge=0.0, sign=1.0):
    """Exact energy-shift factor g = E_obs / E_emit for emission from a
    circular equatorial geodesic orbit at BL radius r_bl, received at
    infinity: sqrt(-(g_tt + 2 Omega g_tphi + Omega^2 g_phph)) /
    (1 - Omega L), clamped to [1e-3, 1e3]."""
    r = torch.clamp(r_bl, min=EPSILON)
    omega = derived.kerr_circular_omega(r, M, a, sign)
    tm = 2.0 * M * r - charge * charge
    g_tt = -(1.0 - tm / (r * r))
    g_tphi = -tm * a / (r * r)
    g_phph = r * r + a * a + tm * a * a / (r * r)
    u2 = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phph)
    num = torch.sqrt(torch.clamp(u2, min=EPSILON))
    den = 1.0 - omega * L
    g = num / torch.where(torch.abs(den) < EPSILON, EPSILON, den)
    return torch.clamp(g, 1e-3, 1e3)


def doppler_factor_compat(hit_pos, photon_dir, M):
    """Simplified factor 1 + 0.5 v.t_hat of the reference's CPU path."""
    x, y = hit_pos[..., 0], hit_pos[..., 1]
    r = torch.clamp(torch.sqrt(x * x + y * y), min=EPSILON)
    v = derived.keplerian_orbital_velocity(r, M)
    tangent = torch.stack([-y / r, x / r, torch.zeros_like(x)], dim=-1)
    d = coords.normalize(photon_dir)
    return 1.0 + 0.5 * v * torch.sum(d * tangent, dim=-1)


def apply_relativistic_effects(color, doppler, grav_redshift,
                               enable_doppler=True, enable_redshift=True,
                               enable_beaming=True):
    """Doppler shift + gravitational redshift + doppler^4 beaming on the
    disk colour (..., 3), clamped to [0, 1]."""
    r, g, b = color[..., 0], color[..., 1], color[..., 2]
    shift = doppler / torch.clamp(grav_redshift, min=EPSILON)
    if enable_doppler or enable_redshift:
        if not enable_doppler:
            shift = 1.0 / torch.clamp(grav_redshift, min=EPSILON)
        if not enable_redshift:
            shift = doppler
        redder = shift < 1.0
        r = torch.where(redder, torch.clamp(r * (2.0 - shift), max=1.0),
                        r * (2.0 - shift))
        b = torch.where(redder, b * shift, torch.clamp(b * shift, max=1.0))
    if enable_beaming:
        beaming = doppler**4
        r = r * beaming
        g = g * beaming
        b = b * beaming
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def sky_color(direction):
    """White-to-blue gradient by the final direction's y component."""
    t = 0.5 * (direction[..., 1] + 1.0)
    r = (1.0 - t) * 1.0 + t * 0.5
    g = (1.0 - t) * 1.0 + t * 0.7
    b = torch.ones_like(t)
    return torch.stack([r, g, b], dim=-1)


def sample_environment(direction, env_map):
    """Bilinear equirect lookup along the final direction: u = azimuth
    atan2(y, x) over [0, W) with wrap, v = polar angle arccos(z) over
    [0, H) with clamp.  env_map: (H, W, 3)."""
    h, w = env_map.shape[-3], env_map.shape[-2]
    d = coords.normalize(direction)
    phi = torch.atan2(d[..., 1], d[..., 0])
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    u = (phi / (2.0 * math.pi) + 0.5) * w - 0.5
    v = (theta / math.pi) * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    iu0 = torch.remainder(u0.to(torch.int64), w)
    iu1 = torch.remainder(iu0 + 1, w)
    iv0 = torch.clamp(v0.to(torch.int64), 0, h - 1)
    iv1 = torch.clamp(iv0 + 1, 0, h - 1)
    c00 = env_map[iv0, iu0]
    c01 = env_map[iv0, iu1]
    c10 = env_map[iv1, iu0]
    c11 = env_map[iv1, iu1]
    return (
        c00 * (1.0 - fu) * (1.0 - fv)
        + c01 * fu * (1.0 - fv)
        + c10 * (1.0 - fu) * fv
        + c11 * fu * fv
    )


def shade_disk_hit(hit_pos, photon_dir, blackhole, disk, config, L=None):
    """Disk shading chain: temperature -> blackbody -> relativistic.

    config.disk_kinematics: "auto" uses the exact Kerr circular-orbit
    g-factor (photon's conserved L) when the disk is equatorial and L is
    given, and the compat factors otherwise; "compat" always uses the
    flat-space Keplerian factors; "kerr" is auto that logs a warning when
    an inclined disk forces the compat fallback.  The equatorial test is
    decided once from the inclination's value.

    Returns (rgb, temperature, doppler, grav_redshift).
    """
    x, y = hit_pos[..., 0], hit_pos[..., 1]
    r_cyl = torch.sqrt(x * x + y * y)
    temp = disk_temperature(
        r_cyl, disk.inner_radius, disk.outer_radius, disk.temperature_scale
    )
    rgb = temperature_to_rgb(temp)
    mode = config.disk_kinematics
    use_kerr = mode in ("auto", "kerr") and L is not None
    equatorial = False
    if use_kerr:
        equatorial = bool(
            torch.all(torch.abs(torch.sin(disk.inclination)) < 1e-6)
        )
        if mode == "kerr" and not equatorial:
            log.warning(
                "disk_kinematics='kerr' requested for an inclined disk: "
                "no circular equatorial geodesics off the equator — "
                "falling back to the compat (flat-space Keplerian) "
                "factors for this scene"
            )
    if use_kerr and equatorial:
        M = blackhole.mass
        a = blackhole.spin * M
        # Equatorial BL radius from the cylindrical one (w = sqrt(r^2+a^2)).
        r_bl = torch.sqrt(torch.clamp(r_cyl * r_cyl - a * a, min=EPSILON))
        g = kerr_g_factor(r_bl, L, M, a, blackhole.charge)
        grav = derived.static_time_dilation_kerr(r_bl, M, a,
                                                 blackhole.charge)
        doppler = g * grav
    else:
        doppler = doppler_factor_relativistic(hit_pos, photon_dir,
                                              blackhole.mass)
        r_sph = torch.linalg.vector_norm(hit_pos, dim=-1)
        grav = derived.time_dilation(r_sph, blackhole.mass)
    rgb = apply_relativistic_effects(
        rgb, doppler, grav,
        enable_doppler=config.enable_doppler,
        enable_redshift=config.enable_redshift,
        enable_beaming=config.enable_beaming,
    )
    return rgb, temp, doppler, grav
