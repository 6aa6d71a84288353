"""Massive-particle dynamics: relativistic geodesics near the hole,
Newtonian gravity far from it.

PyTorch counterpart of blackhole_tpu.particles.dynamics.  Timelike
geodesics use the photon tracer's Hamiltonian force terms
(render.geodesic) with H = -1/2, an RK4 step in proper time and exact
coordinate maps (their Jacobians by torch.func.jvp, batched over the
pool).  Every update runs on the whole pool at once: both regimes are
computed and torch.where picks one per particle, so the geodesic
branch's NaN (far particles, r <= r_+) never reaches a particle that
does not use it.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.metrics import derived, kerr
from blackhole_tpu_torch.particles.system import ParticleSystem, ParticleType
from blackhole_tpu_torch.render import geodesic
from blackhole_tpu_torch.tangent_rules import jmax


def _timelike_init(position, velocity, M, a, Q=0.0):
    """(bl, (p_r, p_theta), E, L) of massive particles from cartesian
    positions and coordinate 3-velocities; dt/dtau from the timelike
    normalisation g_mn u^m u^n = -1."""
    bl, dbl = jvp(lambda x: coords.cartesian_to_boyer_lindquist(x, a),
                  (position,), (velocity,))
    r, theta = bl[..., 0], bl[..., 1]
    dr, dtheta, dphi = dbl[..., 0], dbl[..., 1], dbl[..., 2]

    g = kerr.metric(r, theta, M, a, Q)
    S = g.g_rr * dr**2 + g.g_thth * dtheta**2 + g.g_phph * dphi**2
    # g_tt dt^2 + 2 g_tphi dt dphi + S = -1
    disc = jmax(g.g_tphi**2 * dphi**2 - g.g_tt * (S + 1.0), 0.0)
    dt = (g.g_tphi * dphi + torch.sqrt(disc)) / jmax(-g.g_tt, EPSILON)
    E = -(g.g_tt * dt + g.g_tphi * dphi)
    L = g.g_tphi * dt + g.g_phph * dphi
    p_r = g.g_rr * dr
    p_theta = g.g_thth * dtheta
    return bl, torch.stack([p_r, p_theta], dim=-1), E, L


def _timelike_rhs(y, E, L, M, a, Q=0.0):
    """Hamiltonian flow of y = (r, theta, phi, p_r, p_theta): the photon
    path's force terms (the mass term is constant in x)."""
    r, theta = y[..., 0], y[..., 1]
    p_r, p_theta = y[..., 3], y[..., 4]
    gi = kerr.inverse_metric(r, theta, M, a, Q)
    dr = gi.g_rr * p_r
    dtheta = gi.g_thth * p_theta
    dphi = -gi.g_tphi * E + gi.g_phph * L
    dpr = -geodesic._dH_dr_batched(r, theta, p_r, p_theta, E, L, M, a, Q)
    dpth = -geodesic._dH_dtheta_batched(r, theta, p_r, p_theta, E, L, M, a,
                                        Q)
    return torch.stack([dr, dtheta, dphi, dpr, dpth], dim=-1)


def geodesic_update(position, velocity, dt, M, a, Q=0.0):
    """One RK4 proper-time step of the timelike geodesic; returns the
    new cartesian (position, velocity)."""
    bl, p, E, L = _timelike_init(position, velocity, M, a, Q)
    y = torch.cat([bl, p], dim=-1)

    def f(y):
        return _timelike_rhs(y, E, L, M, a, Q)

    k1 = f(y)
    k2 = f(y + 0.5 * dt * k1)
    k3 = f(y + 0.5 * dt * k2)
    k4 = f(y + dt * k3)
    y_new = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    new_bl = y_new[..., :3]
    # Coordinate velocity back to cartesian through the forward map's
    # Jacobian.
    dsph = f(y_new)[..., :3]
    return jvp(lambda bl3: coords.boyer_lindquist_to_cartesian(bl3, a),
               (new_bl,), (dsph,))


def newtonian_update(position, velocity, dt, M):
    """Euler step under Newtonian gravity a = -M r_hat / r^2."""
    r = torch.linalg.vector_norm(position, dim=-1, keepdim=True)
    accel = -M * position / jmax(r, EPSILON) ** 3
    new_vel = velocity + dt * accel
    new_pos = position + dt * new_vel
    return new_pos, new_vel


def regimes(system: ParticleSystem, blackhole):
    """Per particle: True where the geodesic update applies (TEST
    particles within 20 r_s), False where the Newtonian one does."""
    r = torch.linalg.vector_norm(system.position, dim=-1)
    return ((system.ptype == ParticleType.TEST)
            & (r < 20.0 * blackhole.schwarzschild_radius))


def update_particles(system: ParticleSystem, blackhole, config
                     ) -> ParticleSystem:
    """Advance every active particle by one time step: the geodesic
    update where regimes() says so, the Newtonian one elsewhere;
    particles that end within r_s are deactivated."""
    M = blackhole.mass
    rs = blackhole.schwarzschild_radius
    dt = config.time_step

    use_geo = regimes(system, blackhole)[..., None]
    geo_pos, geo_vel = geodesic_update(
        system.position, system.velocity, dt, M, blackhole.a,
        blackhole.charge)
    newt_pos, newt_vel = newtonian_update(system.position, system.velocity,
                                          dt, M)
    new_pos = torch.where(use_geo, geo_pos, newt_pos)
    new_vel = torch.where(use_geo, geo_vel, newt_vel)

    act = system.active
    new_pos = torch.where(act[..., None], new_pos, system.position)
    new_vel = torch.where(act[..., None], new_vel, system.velocity)

    r_new = torch.linalg.vector_norm(new_pos, dim=-1)
    captured = act & (r_new <= rs)

    return system.replace(
        position=new_pos,
        velocity=new_vel,
        age=torch.where(act, system.age + dt, system.age),
        active=act & ~captured,
        time_dilation=torch.where(
            act, derived.time_dilation(r_new, M), system.time_dilation),
    )
