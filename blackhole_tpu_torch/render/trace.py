"""Trace records and the post-loop shading stage.

PyTorch counterpart of the parts of blackhole_tpu.render.trace that the
geodesic kernel's path calls: the ACTIVE sentinel, the RKF45 error
width, the TraceCarry record, the disk-plane and cartesian helpers, the
analytic capture margin and finalize with the hard shadow edge and the
soft one (shadow_softness > 0).  The XLA-engine counterpart
(trace_step, make_step_fn, trace_rays) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import Hit, RayResult, Scene
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, shading

ACTIVE = -1  # result code while a ray is still integrating

# The RKF45 error criterion spans the 6 physical components only.
N_ERR_COMPONENTS = 6


class TraceCarry(NamedTuple):
    y: torch.Tensor  # (N, 10) trig-augmented geodesic state
    h: torch.Tensor  # (N,) current step size
    L: torch.Tensor  # (N,) conserved angular momentum (E = 1)
    dist: torch.Tensor  # (N,) accumulated cartesian path length
    steps: torch.Tensor  # (N,) int32 steps taken
    result: torch.Tensor  # (N,) int32; ACTIVE while integrating
    hit_pos: torch.Tensor  # (N, 3) recorded hit position
    last_dir: torch.Tensor  # (N, 3) unit direction of the last chord
    min_r: torch.Tensor  # (N,) closest BL radial approach
    iter: int  # global iteration counter
    # Crossing-opacity tracking (None unless track_crossing): the
    # closest sampled approach |z'| to the disk plane while radially
    # inside the annulus, and the position and chord direction there.
    min_az: torch.Tensor | None = None  # (N,)
    gpos: torch.Tensor | None = None  # (N, 3)
    gdir: torch.Tensor | None = None  # (N, 3)


def track_crossing(scene: Scene) -> bool:
    """Carry the crossing-opacity planes?  Only for soft-boundary
    rendering with the disk on."""
    return bool(
        scene.disk_enabled
        and scene.config.show_disk
        and float(scene.config.shadow_softness) > 0.0
    )


def _disk_plane_radius(cart, incl):
    """In-plane radius of a point in the disk frame rotated by incl."""
    x = cart[..., 0]
    yp = torch.cos(incl) * cart[..., 1] + torch.sin(incl) * cart[..., 2]
    return torch.sqrt(x * x + yp * yp)


def aug_to_cartesian(y, a):
    """Quasi-cartesian position from the trig-augmented state:
    x = sqrt(r^2+a^2) sin th cos ph, y = ... sin ph, z = r cos th."""
    r = y[..., geodesic.IR]
    st, ct = y[..., geodesic.IST], y[..., geodesic.ICT]
    sp, cp = y[..., geodesic.ISP], y[..., geodesic.ICP]
    w = torch.sqrt(r * r + a * a)
    rho = w * st
    return torch.stack([rho * cp, rho * sp, r * ct], dim=-1)


def compute_capture_margin(origins, directions, scene: Scene):
    """(margin, valid) of the rays for the analytic soft shadow boundary.

    margin: derived.capture_margin_length from the conserved (L, Qc),
    positive = captured, differentiable in the rays and the scene.
    valid: the ray starts ingoing with C = Qc + (L - a)^2 > EPSILON; a
    primal-only predicate (finalize falls back to min_r elsewhere)."""
    bh = scene.blackhole
    y0, _, L, Qc = geodesic.init_null_rays_aug(
        origins, coords.normalize(directions), bh.mass, bh.a, bh.charge
    )
    margin = derived.capture_margin_length(L, Qc, bh.mass, bh.a, bh.charge)
    C = Qc + (L - bh.a) * (L - bh.a)
    valid = (y0[..., geodesic.IPR] < 0.0) & (C > EPSILON)
    return margin, valid


def finalize(carry: TraceCarry, scene: Scene, margin=None) -> Hit:
    """Convert the final carry into a shaded Hit.

    Under shadow_softness > 0 every visibility flip is softened: the disk
    emission is composited over the sky by the annulus window, over
    non-disk rays by the crossing opacity (when the carry tracks it), and
    the colour is scaled by a survival sigmoid of the capture margin
    (margin = (margin, valid) from compute_capture_margin) or of min_r.
    With a margin given the hard trapped-ray test is switched off for
    every ray, as in the JAX package (a known fault of the reference)."""
    bh = scene.blackhole
    cfg = scene.config
    result = torch.where(
        carry.result == ACTIVE, RayResult.MAX_STEPS, carry.result
    )
    final_cart = aug_to_cartesian(carry.y, bh.a)
    is_disk = result == RayResult.DISK
    pos = torch.where(is_disk[..., None], carry.hit_pos, final_cart)
    r_term = torch.linalg.vector_norm(pos, dim=-1)
    tdil = derived.time_dilation(r_term, bh.mass)
    is_horizon = result == RayResult.HORIZON

    disk_rgb, temp, doppler, grav = shading.shade_disk_hit(
        carry.hit_pos, carry.last_dir, bh, scene.disk, cfg, L=carry.L
    )
    if scene.env_map is not None:
        sky_rgb = shading.sample_environment(carry.last_dir, scene.env_map)
    else:
        sky_rgb = shading.sky_color(carry.last_dir)
    # Budget-exhausted rays that ended inside ~4M are trapped: paint them
    # black like captures instead of sky.
    is_trapped = (result == RayResult.MAX_STEPS) & (r_term < 4.0 * bh.mass)
    if margin is not None:
        is_trapped = torch.zeros_like(is_trapped)
    dark = (is_horizon | is_trapped)[..., None]
    soft = float(cfg.shadow_softness)
    if soft > 0.0:
        # Soft disk edges: emission over the straight-on sky by the
        # annulus window.
        window = shading.disk_edge_window(
            carry.hit_pos, scene.disk, soft * bh.mass
        )[..., None]
        disk_rgb = disk_rgb * window + sky_rgb * (1.0 - window)
    color = torch.where(
        is_disk[..., None], disk_rgb,
        torch.where(dark, torch.zeros_like(sky_rgb), sky_rgb),
    )
    if track_crossing(scene) and carry.min_az is not None:
        # Crossing opacity: disk emission at the closest in-band approach
        # to the plane, over every non-disk ray, by alpha(min_az) times
        # the annulus window (alpha -> sigmoid(3) at a graze).
        w = soft * bh.mass
        g_rgb, _, _, _ = shading.shade_disk_hit(
            carry.gpos, carry.gdir, bh, scene.disk, cfg, L=carry.L
        )
        window_g = shading.disk_edge_window(carry.gpos, scene.disk, w)
        alpha = torch.sigmoid(3.0 - carry.min_az / w)
        cw = (alpha * window_g)[..., None]
        color = torch.where(
            is_disk[..., None], color, color * (1.0 - cw) + g_rgb * cw
        )
    if soft > 0.0:
        # Survival of the shadow boundary: sigmoid(x - 3) of the ray's
        # height above the (prograde / retrograde by the sign of L)
        # photon orbit in units of softness * M; the analytic margin where
        # it is valid and the ray is not a disk hit, min_r elsewhere.
        sgn = torch.where(carry.L.detach() * bh.a >= 0.0, 1.0, -1.0)
        r_ph = derived.kerr_photon_orbit_radius(bh.mass, bh.spin, sgn)
        x_minr = (carry.min_r - r_ph) / (soft * bh.mass)
        if margin is not None:
            m_arr, m_valid = margin
            x_analytic = -m_arr / (soft * bh.mass)
            x = torch.where(m_valid & ~is_disk, x_analytic, x_minr)
        else:
            x = x_minr
        color = color * torch.sigmoid(x - 3.0)[..., None]
    one = torch.ones_like(tdil)

    # Slant optical depth of Sigma(r) = density_scale (r_in/r)^(3/5)
    # through the (possibly inclined) disk plane.
    disk = scene.disk
    incl = disk.inclination
    normal = torch.stack(
        [torch.zeros_like(incl), -torch.sin(incl), torch.cos(incl)], dim=-1
    )
    cos_slant = torch.abs(torch.sum(carry.last_dir * normal, dim=-1))
    r_plane = _disk_plane_radius(carry.hit_pos, incl)
    sigma = disk.density_scale * (
        disk.inner_radius / torch.clamp(r_plane, min=EPSILON)
    ) ** 0.6
    tau = sigma / torch.clamp(cos_slant, min=1e-3)

    return Hit(
        result=result,
        position=pos,
        distance=carry.dist,
        steps=carry.steps,
        time_dilation=tdil,
        sky_direction=carry.last_dir,
        doppler=torch.where(is_disk, doppler, one),
        temperature=torch.where(is_disk, temp, torch.zeros_like(temp)),
        redshift=torch.where(is_disk, grav, one),
        color=color,
        optical_depth=torch.where(is_disk, tau, torch.zeros_like(tau)),
        min_r=carry.min_r,
    )
