"""Structure-of-arrays particle system: a fixed-capacity pool.

PyTorch counterpart of blackhole_tpu.particles.system.  Every field is
a flat tensor on the pool's device, and each operation returns a new
ParticleSystem (a frozen dataclass registered as a pytree, its fields
the leaves).  count and next_id are 0-d int32 tensors on that device,
as the JAX pool's are, so adding a particle needs no host
synchronisation; a full pool returns pid -1.

particle_system_from_reference carries a pool from any object with the
JAX ParticleSystem's attribute names into this package, reading each
leaf through numpy (so it never imports jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_tpu_torch.geom.types import _register


class ParticleType:
    """Particle categories."""

    TEST = 0
    DISK = 1
    HAWKING = 2
    JET = 3


@dataclasses.dataclass(frozen=True)
class ParticleSystem:
    """Fixed-capacity SoA particle pool; pid 0 marks a slot never used."""

    position: torch.Tensor  # (cap, 3)
    velocity: torch.Tensor  # (cap, 3)
    mass: torch.Tensor  # (cap,)
    ptype: torch.Tensor  # (cap,) int32
    pid: torch.Tensor  # (cap,) int32
    active: torch.Tensor  # (cap,) bool
    age: torch.Tensor  # (cap,)
    temperature: torch.Tensor  # (cap,)
    time_dilation: torch.Tensor  # (cap,)
    count: torch.Tensor  # () int32 slots ever used
    next_id: torch.Tensor  # () int32

    @classmethod
    def create(cls, capacity: int, dtype=torch.float32, device="cuda"):
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            position=z(capacity, 3),
            velocity=z(capacity, 3),
            mass=z(capacity),
            ptype=z(capacity, dt=torch.int32),
            pid=z(capacity, dt=torch.int32),
            active=z(capacity, dt=torch.bool),
            age=z(capacity),
            temperature=z(capacity),
            time_dilation=torch.ones((capacity,), dtype=dtype, device=device),
            count=z(dt=torch.int32),
            next_id=torch.ones((), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    def num_active(self):
        return self.active.sum(dtype=torch.int32)

    def replace(self, **changes) -> "ParticleSystem":
        return dataclasses.replace(self, **changes)


_register(ParticleSystem)


def _fill(values, like, n):
    """values as a tensor of like's dtype and device, broadcast to n rows."""
    v = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(v, (n,) + like.shape[1:])


def add_particle(system: ParticleSystem, position, velocity, mass,
                 ptype, temperature=0.0):
    """Append one particle.  Returns (new_system, pid); pid is -1 (and
    the pool unchanged) when the pool is full."""
    full = system.count >= system.capacity
    idx = torch.clamp(system.count, max=system.capacity - 1).long()[None]

    def set_at(arr, val):
        """arr with slot idx set to val, or kept when the pool is full."""
        cur = arr.index_select(0, idx)
        new = torch.where(full, cur, _fill(val, arr, 1))
        return arr.index_copy(0, idx, new)

    new = system.replace(
        position=set_at(system.position, position),
        velocity=set_at(system.velocity, velocity),
        mass=set_at(system.mass, mass),
        ptype=set_at(system.ptype, ptype),
        pid=set_at(system.pid, system.next_id),
        active=set_at(system.active, True),
        age=set_at(system.age, 0.0),
        temperature=set_at(system.temperature, temperature),
        count=torch.where(full, system.count, system.count + 1),
        next_id=torch.where(full, system.next_id, system.next_id + 1),
    )
    return new, torch.where(full, -1, system.next_id)


def add_particles_batch(system: ParticleSystem, positions, velocities,
                        masses, ptypes, temperatures=None):
    """Bulk insert of n particles into the free slots; rows past the
    capacity are dropped and get id -1.  Returns (new_system, ids).

    The dropped rows are written to a scratch row past the end, so every
    kept row lands in its own slot (the JAX package scatters them onto
    the last slot, which can overwrite the last kept row)."""
    n = positions.shape[0]
    cap = system.capacity
    start = system.count
    dev = system.position.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    slots = start + rows
    fits = slots < cap
    dest = torch.clamp(slots, max=cap).long()
    ids = torch.where(fits, system.next_id + rows, -1)
    if temperatures is None:
        temperatures = 0.0

    def scatter(arr, vals):
        pad = torch.cat([arr, arr[:1]])
        return pad.index_copy(0, dest, _fill(vals, arr, n))[:cap]

    n_added = fits.sum(dtype=torch.int32)
    new = system.replace(
        position=scatter(system.position, positions),
        velocity=scatter(system.velocity, velocities),
        mass=scatter(system.mass, masses),
        ptype=scatter(system.ptype, ptypes),
        pid=scatter(system.pid, system.next_id + rows),
        active=scatter(system.active, True),
        age=scatter(system.age, 0.0),
        temperature=scatter(system.temperature, temperatures),
        count=torch.clamp(start + n, max=cap).to(torch.int32),
        next_id=(system.next_id + n_added).to(torch.int32),
    )
    return new, ids


def find_particle(system: ParticleSystem, pid):
    """Index of a live particle by id, or -1."""
    match = (system.pid == pid) & system.active
    idx = torch.argmax(match.to(torch.int32))
    return torch.where(match.any(), idx, -1)


def remove_particle(system: ParticleSystem, pid):
    """Soft-delete by id."""
    return system.replace(active=system.active & (system.pid != pid))


def get_particle_data(system: ParticleSystem):
    """Compacted copy-out of the active particles: (positions,
    velocities, types, count), active entries first in slot order."""
    order = torch.argsort((~system.active).to(torch.int8), stable=True)
    return (
        system.position[order],
        system.velocity[order],
        system.ptype[order],
        system.num_active(),
    )


def particle_system_from_reference(system_like, device="cuda"
                                   ) -> ParticleSystem:
    """ParticleSystem from any object with the JAX ParticleSystem's
    attribute names; each leaf keeps its numpy dtype."""
    return ParticleSystem(*(
        torch.as_tensor(np.array(getattr(system_like, f.name)),
                        device=device)
        for f in dataclasses.fields(ParticleSystem)))
