"""Trace records and the post-loop shading stage.

PyTorch counterpart of the parts of blackhole_tpu.render.trace that the
geodesic kernel's path calls: the ACTIVE sentinel, the RKF45 error
width, the TraceCarry record, the disk-plane and cartesian helpers, and
finalize (hard shadow edge only: shadow_softness == 0).  The XLA-engine
counterpart (trace_step, make_step_fn, trace_rays) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blackhole_tpu_torch.constants import EPSILON
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


def track_crossing(scene: Scene) -> bool:
    """Carry the crossing-opacity planes?  Only for soft-boundary
    rendering with the disk on (not ported yet)."""
    return bool(
        scene.disk_enabled
        and scene.config.show_disk
        and float(scene.config.shadow_softness) > 0.0
    )


def check_hard_edge(scene: Scene) -> None:
    """Raise for the soft shadow boundary, which this port lacks."""
    if float(scene.config.shadow_softness) > 0.0:
        raise NotImplementedError(
            "shadow_softness > 0 (capture margin, crossing tracking) is "
            "not ported yet"
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


def finalize(carry: TraceCarry, scene: Scene) -> Hit:
    """Convert the final carry into a shaded Hit with the hard shadow
    edge (the soft branches, shadow_softness > 0, are not ported)."""
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
    dark = (is_horizon | is_trapped)[..., None]
    color = torch.where(
        is_disk[..., None], disk_rgb,
        torch.where(dark, torch.zeros_like(sky_rgb), sky_rgb),
    )
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
