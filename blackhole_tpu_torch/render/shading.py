"""Disk temperature, blackbody colour and relativistic shading.

PyTorch counterpart of blackhole_tpu.render.shading.  Branch-free over rays, batched over leading dims.  Its max,
min, clip and abs follow JAX's derivative rules (tangent_rules), so
forward and reverse mode through it are the JAX package's.
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
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax, jmin

log = logging.getLogger(__name__)


def temperature_to_rgb(temperature):
    """Piecewise blackbody temperature -> RGB; (...,) K -> (..., 3)."""
    t = (jclip(temperature, MIN_TEMP_K, MAX_TEMP_K) - MIN_TEMP_K) / (
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
    rn = jclip(
        (r_hit - disk_inner) / jmax(disk_outer - disk_inner, EPSILON),
        0.0,
        1.0,
    )
    temp_factor = jmax(1.0 - rn, 1e-9) ** 0.75
    return temp_scale * (DISK_TEMP_BASE_K + DISK_TEMP_RANGE_K * temp_factor)


def doppler_factor_relativistic(hit_pos, photon_dir, M):
    """Special-relativistic Doppler factor of Keplerian disk flow:
    sqrt((1 - beta cos a)/(1 + beta cos a)), beta = sqrt(M/r)."""
    x, y = hit_pos[..., 0], hit_pos[..., 1]
    r = torch.sqrt(x * x + y * y)
    beta = jclip(
        derived.keplerian_orbital_velocity(r, M), 0.0, 1.0 - 1e-6
    )
    tangent = torch.stack(
        [-y, x, torch.zeros_like(x)], dim=-1
    ) / jmax(r, EPSILON)[..., None]
    d = coords.normalize(photon_dir)
    cos_angle = torch.sum(d * tangent, dim=-1)
    return torch.sqrt(
        jmax(1.0 - beta * cos_angle, EPSILON)
        / jmax(1.0 + beta * cos_angle, EPSILON)
    )


def kerr_g_factor(r_bl, L, M, a, charge=0.0, sign=1.0):
    """Exact energy-shift factor g = E_obs / E_emit for emission from a
    circular equatorial geodesic orbit at BL radius r_bl, received at
    infinity: sqrt(-(g_tt + 2 Omega g_tphi + Omega^2 g_phph)) /
    (1 - Omega L), clamped to [1e-3, 1e3]."""
    r = jmax(r_bl, EPSILON)
    omega = derived.kerr_circular_omega(r, M, a, sign)
    tm = 2.0 * M * r - charge * charge
    g_tt = -(1.0 - tm / (r * r))
    g_tphi = -tm * a / (r * r)
    g_phph = r * r + a * a + tm * a * a / (r * r)
    u2 = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phph)
    num = torch.sqrt(jmax(u2, EPSILON))
    den = 1.0 - omega * L
    g = num / torch.where(torch.abs(den) < EPSILON, EPSILON, den)
    return jclip(g, 1e-3, 1e3)


def doppler_factor_compat(hit_pos, photon_dir, M):
    """Simplified factor 1 + 0.5 v.t_hat of the reference's CPU path."""
    x, y = hit_pos[..., 0], hit_pos[..., 1]
    r = jmax(torch.sqrt(x * x + y * y), EPSILON)
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
    shift = doppler / jmax(grav_redshift, EPSILON)
    if enable_doppler or enable_redshift:
        if not enable_doppler:
            shift = 1.0 / jmax(grav_redshift, EPSILON)
        if not enable_redshift:
            shift = doppler
        redder = shift < 1.0
        r = torch.where(redder, jmin(r * (2.0 - shift), 1.0),
                        r * (2.0 - shift))
        b = torch.where(redder, b * shift, jmin(b * shift, 1.0))
    if enable_beaming:
        beaming = doppler**4
        r = r * beaming
        g = g * beaming
        b = b * beaming
    return jclip(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def doppler_shift_wavelength(wavelength, radial_velocity):
    """Relativistic longitudinal Doppler shift lambda sqrt((1 + beta) /
    (1 - beta)), beta the radial velocity over c (positive: receding)."""
    beta = jclip(radial_velocity, -1.0 + 1e-6, 1.0 - 1e-6)
    return wavelength * torch.sqrt((1.0 + beta) / (1.0 - beta))


def apply_redshift_to_rgb(color, redshift_z):
    """Shift an RGB colour by redshift z: the colour's pseudo
    temperature (from its blue/red balance) is divided by 1 + z and
    mapped back through the blackbody palette at the colour's luminance
    dimmed by (1 + z)^-4."""
    z1 = jmax(1.0 + redshift_z, 1e-3)
    r, g, b = color[..., 0], color[..., 1], color[..., 2]
    lum = jmax(0.2126 * r + 0.7152 * g + 0.0722 * b, EPSILON)
    balance = (b - r) / jmax(r + g + b, EPSILON)
    t_norm = jclip(0.5 + 0.5 * balance, 0.0, 1.0)
    temp = MIN_TEMP_K + t_norm * (MAX_TEMP_K - MIN_TEMP_K)
    shifted = temperature_to_rgb(temp / z1)
    dimming = (1.0 / z1) ** 4
    scale = lum / jmax(
        0.2126 * shifted[..., 0]
        + 0.7152 * shifted[..., 1]
        + 0.0722 * shifted[..., 2],
        EPSILON,
    )
    return jclip(shifted * (scale * dimming)[..., None], 0.0, 1.0)


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
    theta = torch.arccos(jclip(d[..., 2], -1.0, 1.0))
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
    an inclined disk forces the compat fallback.  Eager calls decide the
    equatorial test once from the inclination's value.  Under
    torch.export the inclination is a runtime input of the program, so
    both kinematic paths are computed and torch.where picks per batch,
    as the JAX package does for a traced inclination.

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

    def kerr_factors():
        M = blackhole.mass
        a = blackhole.spin * M
        # Equatorial BL radius from the cylindrical one (w = sqrt(r^2+a^2)).
        r_bl = torch.sqrt(jmax(r_cyl * r_cyl - a * a, EPSILON))
        g = kerr_g_factor(r_bl, L, M, a, blackhole.charge)
        grav_k = derived.static_time_dilation_kerr(r_bl, M, a,
                                                   blackhole.charge)
        return g * grav_k, grav_k

    def compat_factors():
        doppler_c = doppler_factor_relativistic(hit_pos, photon_dir,
                                                blackhole.mass)
        r_sph = torch.linalg.vector_norm(hit_pos, dim=-1)
        return doppler_c, derived.time_dilation(r_sph, blackhole.mass)

    def equatorial():
        return torch.abs(torch.sin(disk.inclination)) < 1e-6

    if use_kerr and torch.compiler.is_exporting():
        doppler_k, grav_k = kerr_factors()
        doppler_c, grav_c = compat_factors()
        doppler = torch.where(equatorial(), doppler_k, doppler_c)
        grav = torch.where(equatorial(), grav_k, grav_c)
    else:
        static_eq = use_kerr and bool(torch.all(equatorial()))
        if use_kerr and mode == "kerr" and not static_eq:
            log.warning(
                "disk_kinematics='kerr' requested for an inclined disk: "
                "no circular equatorial geodesics off the equator — "
                "falling back to the compat (flat-space Keplerian) "
                "factors for this scene"
            )
        doppler, grav = kerr_factors() if static_eq else compat_factors()
    rgb = apply_relativistic_effects(
        rgb, doppler, grav,
        enable_doppler=config.enable_doppler,
        enable_redshift=config.enable_redshift,
        enable_beaming=config.enable_beaming,
    )
    return rgb, temp, doppler, grav


def disk_edge_window(hit_pos, disk, width):
    """Soft opacity window at the annulus edges: sigmoid ramps of the
    inclined in-plane radius, offset by -3 so the hard in/out flip lands
    at ~5% opacity, 1 in the interior.  trace.finalize composites disk
    emission over the sky with it under SimConfig.shadow_softness, so a
    ray flipping in or out of the disk changes colour continuously."""
    incl = disk.inclination
    x = hit_pos[..., 0]
    yp = torch.cos(incl) * hit_pos[..., 1] + torch.sin(incl) * hit_pos[..., 2]
    r_plane = torch.sqrt(x * x + yp * yp)
    return torch.sigmoid(
        (r_plane - disk.inner_radius) / width - 3.0
    ) * torch.sigmoid((disk.outer_radius - r_plane) / width - 3.0)
