"""Null geodesic initialisation in Kerr-Newman (the forward path's subset).

PyTorch counterpart of blackhole_tpu.render.geodesic: state indices,
the Carter constant, and the exact null-ray initialisation with the
trig-augmented state the geodesic kernel integrates.

State layout (per ray): y = [r, theta, phi, p_r, p_theta, t]; the
augmented form appends [sin th, cos th, sin ph, cos ph].  E is
normalised to 1, L = p_phi is conserved.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.metrics import kerr

# State indices.
IR, ITH, IPH, IPR, IPT, IT = 0, 1, 2, 3, 4, 5
NSTATE = 6
IST, ICT, ISP, ICP = 6, 7, 8, 9
NAUG = 10


def carter_constant(y, E, L, a):
    """Carter constant Q = p_theta^2 + cos^2(theta) (L^2/sin^2 - a^2 E^2)."""
    theta, p_theta = y[..., ITH], y[..., IPT]
    ct, st = torch.cos(theta), torch.sin(theta)
    st2 = torch.clamp(st * st, min=EPSILON)
    return p_theta * p_theta + ct * ct * (L * L / st2 - a * a * E * E)


def augment_state(y):
    """[r, th, ph, p_r, p_th, t] -> trig-augmented 10-state."""
    theta, phi = y[..., ITH], y[..., IPH]
    trig = torch.stack([torch.sin(theta), torch.cos(theta),
                        torch.sin(phi), torch.cos(phi)], dim=-1)
    return torch.cat([y, trig], dim=-1)


def init_null_rays_aug(origin, direction, M, a, Q=0.0):
    """init_null_rays returning the trig-augmented state."""
    y, E, L, Qc = init_null_rays(origin, direction, M, a, Q)
    return augment_state(y), E, L, Qc


def init_null_rays(origin, direction, M, a, Q=0.0):
    """Photon state from cartesian origin + direction (..., 3).

    Boyer-Lindquist position by the closed-form inversion; the BL
    velocity is the forward-mode derivative of that coordinate map along
    the direction, taken with torch.func.jvp (the JAX package uses
    jax.jvp); dt/dlambda from the full null condition with the g_tphi
    cross term.  The affine parameter is rescaled so that E = 1.
    Returns (y, E, L, Q) with y (..., 6).
    """
    # Nudge rays off the polar axis, where arccos/atan2 are non-smooth:
    # rho/r ~ 2e-3 keeps 1 - z/r above float32's epsilon.
    x, yy = origin[..., 0], origin[..., 1]
    rel = 2e-3 if origin.dtype == torch.float32 else 1e-6
    rho2 = x * x + yy * yy
    r2 = rho2 + origin[..., 2] ** 2
    on_axis = rho2 < (rel * rel) * r2
    nudge = torch.where(
        on_axis, rel * torch.sqrt(torch.clamp(r2, min=EPSILON)), 0.0
    )
    origin = torch.stack([x + nudge, yy, origin[..., 2]], dim=-1)

    def bl_map(p):
        return coords.cartesian_to_boyer_lindquist(p, a)

    bl, dbl = jvp(bl_map, (origin,), (direction,))
    r, theta, phi = bl[..., 0], bl[..., 1], bl[..., 2]
    dr, dtheta, dphi = dbl[..., 0], dbl[..., 1], dbl[..., 2]

    g = kerr.metric(r, theta, M, a, Q)
    # Null condition: g_tt dt^2 + 2 g_tphi dt dphi + S = 0.
    S = g.g_rr * dr * dr + g.g_thth * dtheta * dtheta + g.g_phph * dphi * dphi
    disc = torch.clamp(g.g_tphi * g.g_tphi * dphi * dphi - g.g_tt * S,
                       min=0.0)
    dt = (g.g_tphi * dphi + torch.sqrt(disc)) / torch.clamp(-g.g_tt,
                                                            min=EPSILON)

    E = -(g.g_tt * dt + g.g_tphi * dphi)
    L = g.g_tphi * dt + g.g_phph * dphi
    p_r = g.g_rr * dr
    p_theta = g.g_thth * dtheta

    inv_E = 1.0 / torch.clamp(E, min=EPSILON)
    L = L * inv_E
    p_r = p_r * inv_E
    p_theta = p_theta * inv_E
    E = torch.ones_like(E)

    y = torch.stack([r, theta, phi, p_r, p_theta, torch.zeros_like(r)],
                    dim=-1)
    Qc = carter_constant(y, E, L, a)
    return y, E, L, Qc
