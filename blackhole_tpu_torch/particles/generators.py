"""Scene generators: accretion-disk particle seeding, Hawking radiation.

PyTorch counterpart of blackhole_tpu.particles.generators.  Each
generator is its uniform draws (from an explicit torch.Generator, on
the generator's device) and a deterministic transform of them, so the
transform can be held to the JAX package's on jax.random's own draws;
the draws themselves differ from jax.random's for the same seed.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import TWO_PI
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.particles.system import (
    ParticleSystem,
    ParticleType,
    add_particles_batch,
)
from blackhole_tpu_torch.tangent_rules import jmax


def _uniform(generator, shape, dtype, low=0.0, high=1.0):
    return torch.empty(shape, dtype=dtype, device=generator.device).uniform_(
        low, high, generator=generator)


def accretion_disk_draws(generator, n, dtype=torch.float32):
    """The disk's uniforms, as jax.random.split(key, 3) feeds them:
    (u_phi (n,), u_z (n,), u_turb (n, 3)) in [0, 1)."""
    return (_uniform(generator, (n,), dtype), _uniform(generator, (n,), dtype),
            _uniform(generator, (n, 3), dtype))


def accretion_disk_transform(u_phi, u_z, u_turb, blackhole, disk):
    """Disk particles from their uniforms:

    * radii sqrt-spaced for a uniform surface density over
      [max(inner, ISCO, 1.1 r_s), outer];
    * Keplerian tangential velocity plus 5% turbulence;
    * z jitter of thickness_factor * r;
    * T = temp_scale * 10000 * (r_in / r)^0.75.

    Returns (positions, velocities, temperatures)."""
    n = u_phi.shape[0]
    M = blackhole.mass
    isco = derived.isco_radius(M, blackhole.spin)
    inner = jmax(disk.inner_radius, isco)
    inner = jmax(inner, 1.1 * blackhole.schwarzschild_radius)
    outer = disk.outer_radius

    t = torch.linspace(0.0, 1.0, n, dtype=u_phi.dtype, device=u_phi.device)
    r = inner + (outer - inner) * torch.sqrt(t)
    phi = u_phi * TWO_PI
    z = (u_z - 0.5) * disk.thickness_factor * r
    positions = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                            dim=-1)

    v_orbit = torch.sqrt(M / r)
    velocities = torch.stack(
        [-positions[:, 1] * v_orbit / r, positions[:, 0] * v_orbit / r,
         torch.zeros_like(r)],
        dim=-1,
    )
    turb = (u_turb - 0.5) * (0.05 * v_orbit)[:, None]
    velocities = velocities + turb

    temperatures = disk.temperature_scale * 10000.0 * (inner / r) ** 0.75
    return positions, velocities, temperatures


def accretion_disk_particles(generator, n, blackhole, disk):
    """Sample n disk particles: (positions, velocities, temperatures)."""
    draws = accretion_disk_draws(generator, n, blackhole.mass.dtype)
    return accretion_disk_transform(*draws, blackhole, disk)


def hawking_draws(generator, n, dtype=torch.float32):
    """The Hawking particles' uniforms: (cos_t (n,) in [-1, 1), u_phi
    (n,), u_pert (n, 3) in [0, 1))."""
    return (_uniform(generator, (n,), dtype, -1.0, 1.0),
            _uniform(generator, (n,), dtype),
            _uniform(generator, (n, 3), dtype))


def hawking_transform(cos_t, u_phi, u_pert, blackhole, temp_factor=1.0):
    """Hawking-radiation particles from their uniforms: isotropic at
    1.01 r_s (cos theta uniform), 0.9c outward plus a perturbation,
    T = temp_factor / (8 pi M).  Returns (positions, velocities,
    temperatures)."""
    n = cos_t.shape[0]
    rs = blackhole.schwarzschild_radius
    theta = torch.arccos(cos_t)
    phi = u_phi * TWO_PI
    r = torch.broadcast_to(1.01 * rs, (n,)).to(cos_t.dtype)
    positions = coords.spherical_to_cartesian(
        torch.stack([r, theta, phi], dim=-1))

    velocities = coords.normalize(positions) * 0.9
    pert = (u_pert - 0.5) * 0.2
    velocities = coords.normalize(velocities + pert) * 0.9

    temp = torch.broadcast_to(
        temp_factor * derived.hawking_temperature(blackhole.mass), (n,))
    return positions, velocities, temp


def hawking_radiation_particles(generator, n, blackhole, temp_factor=1.0):
    """Sample n Hawking particles: (positions, velocities, temperatures)."""
    draws = hawking_draws(generator, n, blackhole.mass.dtype)
    return hawking_transform(*draws, blackhole, temp_factor)


def create_accretion_disk(system: ParticleSystem, generator, n, blackhole,
                          disk):
    """Seed n disk particles into the pool; returns (system, ids)."""
    pos, vel, temp = accretion_disk_particles(generator, n, blackhole, disk)
    return add_particles_batch(system, pos, vel, 0.0, ParticleType.DISK,
                               temp)


def generate_hawking_radiation(system: ParticleSystem, generator, n,
                               blackhole, temp_factor=1.0):
    """Add n Hawking particles to the pool; returns (system, ids)."""
    pos, vel, temp = hawking_radiation_particles(generator, n, blackhole,
                                                 temp_factor)
    return add_particles_batch(system, pos, vel, 0.0, ParticleType.HAWKING,
                               temp)
