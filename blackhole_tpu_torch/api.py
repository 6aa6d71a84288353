"""Public API facade: the bh_* surface of the framework.

PyTorch counterpart of blackhole_tpu.api, function for function:

    bh_initialize / bh_shutdown
    bh_configure_black_hole / bh_configure_accretion_disk /
    bh_configure_simulation
    bh_trace_ray / bh_trace_rays_batch
    bh_create_particle_system / bh_destroy_particle_system
    bh_add_test_particle / bh_create_accretion_disk_particles /
    bh_generate_hawking_radiation / bh_update_particles /
    bh_get_particle_data
    bh_calculate_time_dilation / bh_get_version
    bh_calculate_orbital_velocity / blackhole_get_mass
    bh_generate_shader_data

The context is a thin mutable holder of immutable records on one device
(the card unless bh_initialize is asked for another); every record and
particle pool it makes lives there.  bh_trace_rays_batch goes through
render.image.trace_rays_fast: the CUDA geodesic kernel on a CUDA
context, its plain version on a CPU one.  The setters return BHError
codes, as the C API does; the other entry points raise on bad input.

context_from_reference carries a context from any object with the JAX
BHContext's attribute names into this package (never importing jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_tpu_torch import constants
from blackhole_tpu_torch.geom.types import (
    BlackHole,
    Disk,
    Hit,
    Scene,
    SimConfig,
    scene_from_reference,
)
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.particles import dynamics, generators
from blackhole_tpu_torch.particles import system as psys
from blackhole_tpu_torch.render import image, trace


class BHError:
    """Error codes of the C API."""

    SUCCESS = 0
    INVALID_PARAMETER = -1
    MEMORY_ALLOCATION = -2
    INITIALIZATION = -3
    SIMULATION = -4


@dataclasses.dataclass
class BHContext:
    """Engine context: black hole, disk, config and the disk flag, with
    the dtype and device of every record it makes."""

    blackhole: BlackHole
    disk: Disk
    config: SimConfig
    disk_enabled: bool = False
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")

    def scene(self) -> Scene:
        return Scene(
            blackhole=self.blackhole,
            disk=self.disk,
            config=self.config,
            disk_enabled=self.disk_enabled,
        )

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)


def bh_initialize(dtype=torch.float32, device="cuda") -> BHContext:
    """A context with the reference defaults: M = 1 Schwarzschild, disk
    6..20 M (disabled), step 0.1, 1000 steps, tolerance 1e-6."""
    dev = dict(dtype=dtype, device=device)
    return BHContext(
        blackhole=BlackHole.create(1.0, 0.0, 0.0, **dev),
        disk=Disk.create(6.0, 20.0, 1.0, 1.0, **dev),
        config=SimConfig.create(
            time_step=0.1,
            max_ray_distance=100.0,
            max_steps=1000,
            tolerance=1e-6,
            **dev,
        ),
        disk_enabled=False,
        dtype=dtype,
        device=torch.device(device),
    )


def context_from_reference(ctx_like, device="cuda") -> BHContext:
    """BHContext from any object with the JAX BHContext's attribute
    names (blackhole, disk, config, disk_enabled, dtype)."""
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[np.dtype(ctx_like.dtype)]
    scene = scene_from_reference(ctx_like, device, dtype)
    return BHContext(scene.blackhole, scene.disk, scene.config,
                     scene.disk_enabled, dtype, torch.device(device))


def bh_shutdown(context: BHContext) -> None:
    """No-op for API parity (device memory is freed by the allocator)."""


def bh_get_version():
    """(major, minor, patch)."""
    return (
        constants.VERSION_MAJOR,
        constants.VERSION_MINOR,
        constants.VERSION_PATCH,
    )


def blackhole_get_mass(context: BHContext) -> float:
    return float(context.blackhole.mass)


def bh_calculate_orbital_velocity(context: BHContext, r: float) -> float:
    """v = sqrt(M/r)."""
    if r <= 0:
        raise ValueError("r must be positive")
    return float(derived.keplerian_orbital_velocity(
        context.tensor(r), context.blackhole.mass))


def bh_configure_black_hole(context: BHContext, mass, spin, charge=0.0
                            ) -> int:
    """Validated setter: mass > 0, 0 <= spin <= 1, and sub-extremal
    overall: (spin M)^2 + Q^2 <= M^2."""
    if mass <= 0.0 or not (0.0 <= spin <= 1.0):
        return BHError.INVALID_PARAMETER
    if (spin * mass) ** 2 + charge**2 > mass**2:
        return BHError.INVALID_PARAMETER
    context.blackhole = BlackHole.create(mass, spin, charge,
                                         device=context.device,
                                         dtype=context.dtype)
    return BHError.SUCCESS


def bh_configure_accretion_disk(context: BHContext, inner_radius,
                                outer_radius, temperature_scale,
                                density_scale, **kw) -> int:
    """Validated setter; enables the disk."""
    if (
        inner_radius <= 0.0
        or outer_radius <= inner_radius
        or temperature_scale <= 0.0
        or density_scale <= 0.0
    ):
        return BHError.INVALID_PARAMETER
    context.disk = Disk.create(
        inner_radius, outer_radius, temperature_scale, density_scale,
        device=context.device, dtype=context.dtype, **kw
    )
    context.disk_enabled = True
    return BHError.SUCCESS


def bh_configure_simulation(context: BHContext, time_step,
                            max_ray_distance, max_integration_steps,
                            tolerance, **kw) -> int:
    """Validated setter; a bad keyword option returns INVALID_PARAMETER
    too, never raises."""
    if (
        time_step <= 0.0
        or max_ray_distance <= 0.0
        or max_integration_steps <= 0
        or tolerance <= 0.0
    ):
        return BHError.INVALID_PARAMETER
    try:
        context.config = SimConfig.create(
            time_step=time_step,
            max_ray_distance=max_ray_distance,
            max_steps=max_integration_steps,
            tolerance=tolerance,
            device=context.device,
            dtype=context.dtype,
            **kw,
        )
    except (ValueError, TypeError):
        return BHError.INVALID_PARAMETER
    return BHError.SUCCESS


def bh_trace_ray(context: BHContext, origin, direction) -> Hit:
    """Trace one ray by the XLA engine (render.trace.trace_rays); the
    direction is normalised internally.  Returns a Hit of 0-d fields."""
    o = context.tensor(origin)[None, :]
    d = context.tensor(direction)[None, :]
    return trace.trace_rays(o, d, context.scene())[0]


def bh_trace_rays_batch(context: BHContext, origins, directions,
                        engine: str = "auto") -> Hit:
    """Trace a batch of rays (..., 3) in one computation, by
    image.trace_rays_fast's engine ("auto": the geodesic kernel for RK4
    and RKF45, on a CUDA context the hand-written CUDA kernel; "xla":
    the XLA engine)."""
    return image.trace_rays_fast(context.tensor(origins),
                                 context.tensor(directions),
                                 context.scene(), engine)


# --- the particle system ---


def bh_create_particle_system(context: BHContext, capacity: int
                              ) -> psys.ParticleSystem:
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    return psys.ParticleSystem.create(capacity, dtype=context.dtype,
                                      device=context.device)


def bh_destroy_particle_system(context: BHContext,
                               system: psys.ParticleSystem) -> None:
    """No-op for API parity (device memory is freed by the allocator)."""


def bh_add_test_particle(context: BHContext, system, position, velocity,
                         mass):
    """Returns (new_system, particle_id); the id is -1 when full."""
    if mass < 0.0:
        raise ValueError("mass must be non-negative")
    return psys.add_particle(
        system,
        context.tensor(position),
        context.tensor(velocity),
        mass,
        psys.ParticleType.TEST,
    )


def _generator(context: BHContext, seed: int) -> torch.Generator:
    return torch.Generator(device=context.device).manual_seed(seed)


def bh_create_accretion_disk_particles(context: BHContext, system,
                                       num_particles, generator=None):
    """Seed disk particles (none while the disk is disabled); returns
    (new_system, n_created).  generator: a torch.Generator on the
    context's device, seeded 0 by default."""
    if not context.disk_enabled:
        return system, 0
    if generator is None:
        generator = _generator(context, 0)
    new_sys, ids = generators.create_accretion_disk(
        system, generator, num_particles, context.blackhole, context.disk
    )
    return new_sys, int((ids >= 0).sum())


def bh_generate_hawking_radiation(context: BHContext, system,
                                  num_particles, generator=None):
    """Add Hawking particles; returns (new_system, n_created).
    generator: as above, seeded 1 by default."""
    if generator is None:
        generator = _generator(context, 1)
    new_sys, ids = generators.generate_hawking_radiation(
        system, generator, num_particles, context.blackhole
    )
    return new_sys, int((ids >= 0).sum())


def bh_update_particles(context: BHContext, system) -> psys.ParticleSystem:
    """One time step for the whole pool."""
    return dynamics.update_particles(
        system, context.blackhole, context.config
    )


def bh_get_particle_data(context: BHContext, system):
    """Compacted (positions, velocities, types, count)."""
    return psys.get_particle_data(system)


def bh_calculate_time_dilation(context: BHContext, position1, position2
                               ) -> float:
    """Ratio of the time dilation at position1 to that at position2."""
    r1 = torch.linalg.vector_norm(context.tensor(position1))
    r2 = torch.linalg.vector_norm(context.tensor(position2))
    d1 = derived.time_dilation(r1, context.blackhole.mass)
    d2 = derived.time_dilation(r2, context.blackhole.mass)
    return float(d1 / d2)


def bh_generate_shader_data(
    context: BHContext,
    observer_pos,
    observer_dir,
    up_vector,
    width: int,
    height: int,
    fov: float,
    enable_doppler: bool = True,
    enable_redshift: bool = True,
    show_disk: bool = True,
) -> np.ndarray:
    """Packed float32 parameter block for a shader, in the reference's
    field order:
    [mass, spin, rs, r_isco, r_horizon,
     disk_inner, disk_outer, disk_temp_scale, disk_density_scale,
     observer_pos(3), observer_dir(3), up_vector(3),
     fov_radians, aspect_ratio,
     enable_doppler, enable_redshift, show_disk,
     max_steps, step_size, tolerance, max_distance,
     padding(4)]
    """
    bh = context.blackhole
    show = bool(show_disk and context.disk_enabled)
    if show:
        disk_block = [
            float(context.disk.inner_radius),
            float(context.disk.outer_radius),
            float(context.disk.temperature_scale),
            float(context.disk.density_scale),
        ]
    else:
        # Disabled by inverted radii.
        disk_block = [1000.0, 100.0, 0.0, 0.0]
    return np.array(
        [
            float(bh.mass),
            float(bh.spin),
            float(bh.schwarzschild_radius),
            float(derived.isco_radius(bh.mass, bh.spin)),
            float(bh.r_plus),
            *disk_block,
            *[float(v) for v in observer_pos],
            *[float(v) for v in observer_dir],
            *[float(v) for v in up_vector],
            float(fov) * np.pi / 180.0,
            width / height,
            float(enable_doppler),
            float(enable_redshift),
            float(show),
            float(context.config.max_steps),
            float(context.config.time_step),
            float(context.config.tolerance),
            float(context.config.max_ray_distance),
            0.0, 0.0, 0.0, 0.0,
        ],
        dtype=np.float32,
    )
