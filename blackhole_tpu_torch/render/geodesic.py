"""Null geodesics in Kerr-Newman: Hamiltonian flow and initialisation.

PyTorch counterpart of blackhole_tpu.render.geodesic: state indices,
the super-Hamiltonian H = 1/2 g^{mu nu} p_mu p_nu and its flow (rhs on
the 6-state; rhs_core / rhs_aug on the trig-augmented state, which the
XLA engine integrates and whose algebra the geodesic kernel repeats),
the Carter constant, and the exact null-ray initialisation.

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
from blackhole_tpu_torch.tangent_rules import jmax

# State indices.
IR, ITH, IPH, IPR, IPT, IT = 0, 1, 2, 3, 4, 5
NSTATE = 6
IST, ICT, ISP, ICP = 6, 7, 8, 9
NAUG = 10


def hamiltonian(r, theta, p_r, p_theta, E, L, M, a, Q=0.0):
    """1/2 g^{mu nu} p_mu p_nu with p_t = -E, p_phi = L.  Null rays: 0."""
    gi = kerr.inverse_metric(r, theta, M, a, Q)
    return 0.5 * (
        gi.g_tt * E * E
        - 2.0 * gi.g_tphi * E * L
        + gi.g_phph * L * L
        + gi.g_rr * p_r * p_r
        + gi.g_thth * p_theta * p_theta
    )


def rhs(y, E, L, M, a, Q=0.0):
    """Geodesic right-hand side dy/dlambda of y = (r, th, ph, pr, pth, t):
    y (..., 6), E and L (...,) or scalars; returns (..., 6)."""
    r, theta = y[..., IR], y[..., ITH]
    p_r, p_theta = y[..., IPR], y[..., IPT]
    gi = kerr.inverse_metric(r, theta, M, a, Q)
    dr = gi.g_rr * p_r
    dtheta = gi.g_thth * p_theta
    dphi = -gi.g_tphi * E + gi.g_phph * L
    dt = -gi.g_tt * E + gi.g_tphi * L
    dpr = -_dH_dr_batched(r, theta, p_r, p_theta, E, L, M, a, Q)
    dpth = -_dH_dtheta_batched(r, theta, p_r, p_theta, E, L, M, a, Q)
    return torch.stack([dr, dtheta, dphi, dpr, dpth, dt], dim=-1)


def _dH_dr_batched(r, theta, p_r, p_theta, E, L, M, a, Q=0.0):
    """Closed-form dH/dr, from the r-derivative of each inverse-metric
    component (equal to autograd of `hamiltonian`)."""
    ct = torch.cos(theta)
    st = torch.sin(theta)
    st2 = jmax(st * st, EPSILON)
    a2 = a * a
    sigma = r * r + a2 * ct * ct
    delta = r * r - 2.0 * M * r + a2 + Q * Q
    tm = 2.0 * M * r - Q * Q  # charged mass term; d(tm)/dr = 2M
    dsigma = 2.0 * r
    ddelta = 2.0 * r - 2.0 * M
    r2a2 = r * r + a2
    A = r2a2 * r2a2 - delta * a2 * st2
    dA = 4.0 * r * r2a2 - ddelta * a2 * st2
    inv_sd = 1.0 / (sigma * delta)
    dinv_sd = -(dsigma * delta + sigma * ddelta) * inv_sd * inv_sd

    dg_tt = -(dA * inv_sd + A * dinv_sd)
    dg_tphi = -a * (2.0 * M * inv_sd + tm * dinv_sd)
    dg_rr = (ddelta * sigma - delta * dsigma) / (sigma * sigma)
    dg_thth = -dsigma / (sigma * sigma)
    dg_phph = (ddelta * inv_sd + (delta - a2 * st2) * dinv_sd) / st2

    return 0.5 * (
        dg_tt * E * E
        - 2.0 * dg_tphi * E * L
        + dg_phph * L * L
        + dg_rr * p_r * p_r
        + dg_thth * p_theta * p_theta
    )


def _dH_dtheta_batched(r, theta, p_r, p_theta, E, L, M, a, Q=0.0):
    """Closed-form dH/dtheta (as _dH_dr_batched)."""
    ct = torch.cos(theta)
    st = torch.sin(theta)
    st2 = jmax(st * st, EPSILON)
    dst2 = 2.0 * st * ct
    a2 = a * a
    sigma = r * r + a2 * ct * ct
    delta = r * r - 2.0 * M * r + a2 + Q * Q
    tm = 2.0 * M * r - Q * Q
    dsigma = -a2 * dst2  # d(a^2 cos^2)/dtheta = -a^2 * 2 sin cos
    r2a2 = r * r + a2
    A = r2a2 * r2a2 - delta * a2 * st2
    dA = -delta * a2 * dst2
    inv_sd = 1.0 / (sigma * delta)
    dinv_sd = -(dsigma * delta) * inv_sd * inv_sd

    dg_tt = -(dA * inv_sd + A * dinv_sd)
    dg_tphi = -tm * a * dinv_sd
    dg_rr = -delta * dsigma / (sigma * sigma)
    dg_thth = -dsigma / (sigma * sigma)
    # g^phph = (Delta - a^2 st2) / (Sigma Delta st2)
    num = delta - a2 * st2
    dnum = -a2 * dst2
    dg_phph = (
        dnum * inv_sd / st2
        + num * dinv_sd / st2
        - num * inv_sd * dst2 / (st2 * st2)
    )

    return 0.5 * (
        dg_tt * E * E
        - 2.0 * dg_tphi * E * L
        + dg_phph * L * L
        + dg_rr * p_r * p_r
        + dg_thth * p_theta * p_theta
    )


def _times(x, E):
    """x * E, skipped when E is the Python float 1.0 (every trace path's
    E): exact, and one eager kernel less."""
    return x if isinstance(E, float) and E == 1.0 else x * E


def rhs_core(r, st, ct, p_r, p_theta, E, L, M, a, Q=0.0):
    """Closed-form geodesic RHS given the carried (sin th, cos th): the
    algebra of rhs, _dH_dr_batched and _dH_dtheta_batched without a
    transcendental.  Returns (dr, dtheta, dphi, dp_r, dp_theta, dt).
    Each subexpression the JAX package writes twice is computed once
    here (the same operations in the same order, so the same bits)."""
    st2 = jmax(st * st, EPSILON)
    a2 = a * a
    rr = r * r
    two_M = 2.0 * M
    Q2 = Q * Q
    two_Mr = two_M * r
    sigma = rr + a2 * ct * ct
    delta = rr - two_Mr + a2 + Q2
    tm = two_Mr - Q2
    r2a2 = rr + a2
    a2st2 = a2 * st2
    num = delta - a2st2
    A = r2a2 * r2a2 - delta * a2 * st2
    inv_sd = 1.0 / (sigma * delta)
    inv_sigma = 1.0 / sigma
    neg_tm_a = -tm * a

    g_rr_up = delta * inv_sigma
    g_thth_up = inv_sigma
    g_tphi_up = neg_tm_a * inv_sd
    g_tt_up = -A * inv_sd
    g_phph_up = num * inv_sd / st2

    dr = g_rr_up * p_r
    dtheta = g_thth_up * p_theta
    dphi = _times(-g_tphi_up, E) + g_phph_up * L
    dt = _times(-g_tt_up, E) + g_tphi_up * L

    # dH/dr
    dsigma = 2.0 * r
    ddelta = 2.0 * r - two_M
    dA = 4.0 * r * r2a2 - ddelta * a2 * st2
    dinv_sd = -(dsigma * delta + sigma * ddelta) * inv_sd * inv_sd
    dg_tt = -(dA * inv_sd + A * dinv_sd)
    dg_tphi = -a * (two_M * inv_sd + tm * dinv_sd)
    dg_rr = (ddelta * sigma - delta * dsigma) * inv_sigma * inv_sigma
    dg_thth = -dsigma * inv_sigma * inv_sigma
    dg_phph = (ddelta * inv_sd + num * dinv_sd) / st2
    dH_dr = 0.5 * (
        _times(_times(dg_tt, E), E)
        - _times(2.0 * dg_tphi, E) * L
        + dg_phph * L * L
        + dg_rr * p_r * p_r
        + dg_thth * p_theta * p_theta
    )

    # dH/dtheta
    dst2 = 2.0 * st * ct
    neg_a2_dst2 = -a2 * dst2
    dsigma_th = neg_a2_dst2
    dA_th = -delta * a2 * dst2
    dinv_sd_th = -(dsigma_th * delta) * inv_sd * inv_sd
    dg_tt_th = -(dA_th * inv_sd + A * dinv_sd_th)
    dg_tphi_th = neg_tm_a * dinv_sd_th
    dg_rr_th = -delta * dsigma_th * inv_sigma * inv_sigma
    dg_thth_th = -dsigma_th * inv_sigma * inv_sigma
    dnum = neg_a2_dst2
    dg_phph_th = (
        dnum * inv_sd / st2
        + num * dinv_sd_th / st2
        - num * inv_sd * dst2 / (st2 * st2)
    )
    dH_dth = 0.5 * (
        _times(_times(dg_tt_th, E), E)
        - _times(2.0 * dg_tphi_th, E) * L
        + dg_phph_th * L * L
        + dg_rr_th * p_r * p_r
        + dg_thth_th * p_theta * p_theta
    )
    return dr, dtheta, dphi, -dH_dr, -dH_dth, dt


def rhs_aug(y, E, L, M, a, Q=0.0):
    """Geodesic RHS on the trig-augmented state: y (..., 10) ->
    (..., 10), the slaved trig components following d(sin x) =
    cos x dx, d(cos x) = -sin x dx."""
    # One unbind for the ten components (its backward is one stack).
    r, _, _, p_r, p_theta, _, st, ct, sp, cp = y.unbind(-1)
    dr, dtheta, dphi, dpr, dpth, dt = rhs_core(
        r, st, ct, p_r, p_theta, E, L, M, a, Q
    )
    return torch.stack(
        [dr, dtheta, dphi, dpr, dpth, dt,
         ct * dtheta, -st * dtheta, cp * dphi, -sp * dphi],
        dim=-1,
    )


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

    Under torch.export this is the registered operator
    blackhole_tpu_torch::init_null_rays, which runs the same code when
    the program is called: torch.func.jvp's forward-mode rules read
    concrete sizes, so it cannot be traced with a symbolic ray count.
    """
    if torch.compiler.is_exporting():
        return torch.ops.blackhole_tpu_torch.init_null_rays(
            origin, direction,
            *(torch.as_tensor(v, device=origin.device) for v in (M, a, Q)))
    return _init_null_rays(origin, direction, M, a, Q)


@torch.library.custom_op("blackhole_tpu_torch::init_null_rays",
                         mutates_args=())
def _init_null_rays_op(origin: torch.Tensor, direction: torch.Tensor,
                       M: torch.Tensor, a: torch.Tensor, Q: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    return _init_null_rays(origin, direction, M, a, Q)


@_init_null_rays_op.register_fake
def _init_null_rays_shape(origin, direction, M, a, Q):
    dtype = torch.result_type(origin, M)
    batch = origin.shape[:-1]
    return (origin.new_empty(batch + (NSTATE,), dtype=dtype),
            *(origin.new_empty(batch, dtype=dtype) for _ in range(3)))


def _init_null_rays(origin, direction, M, a, Q):
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
