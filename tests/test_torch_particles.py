"""Parity of the port's particle simulator with the JAX package.

particles.system (the pool: add, overflow to pid -1, find, remove,
stable compaction), particles.generators (each transform fed
jax.random's own uniforms, rebuilt with the JAX generators' key
schedule), particles.dynamics (update_particles after 1 and 20 steps on
a 64-particle Kerr pool carried across by
particle_system_from_reference) and particles.orbits.

Tolerances: pool operations give equal arrays; the generators'
transforms within rtol 1e-6; update_particles' positions and
velocities within rtol 1e-4, atol 1e-5 (float32 RK4 steps whose
transcendentals round differently by an ulp), active masks equal;
orbit_parameters within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.particles import dynamics as jdyn
from blackhole_tpu.particles import generators as jgen
from blackhole_tpu.particles import orbits as jorbits
from blackhole_tpu.particles import system as jsys
from blackhole_tpu_torch.geom import types
from blackhole_tpu_torch.particles import dynamics, generators, orbits
from blackhole_tpu_torch.particles import system as psys

torch.set_num_threads(1)  # see tests/test_torch_step.py

F32 = np.float32
FIELDS = ("position", "velocity", "mass", "ptype", "pid", "active", "age",
          "temperature", "time_dilation", "count", "next_id")


def _assert_pools_equal(got, ref, skip_slots=()):
    keep = np.ones(got.capacity, bool)
    keep[list(skip_slots)] = False
    for name in FIELDS:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        if g.ndim:
            g, r = g[keep], r[keep]
        np.testing.assert_array_equal(g, r, err_msg=name)


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, 3)) * 10).astype(F32),
            (rng.normal(size=(n, 3)) * 0.1).astype(F32),
            rng.uniform(0, 1, n).astype(F32),
            rng.integers(0, 4, n).astype(np.int32),
            rng.uniform(1e3, 1e4, n).astype(F32))


@pytest.mark.parametrize("op", ["add", "overflow", "find_remove",
                                "compaction", "batch_overflow"])
def test_pool_operations_match_jax(op):
    cap = 8
    ref = jsys.ParticleSystem.create(cap)
    got = psys.ParticleSystem.create(cap, device="cpu")
    pos, vel, mass, ptype, temp = _rows(0, 12)

    def add_one(i):
        nonlocal ref, got
        ref, rp = jsys.add_particle(ref, pos[i], vel[i], mass[i], ptype[i],
                                    temp[i])
        got, gp = psys.add_particle(got, torch.from_numpy(pos[i]),
                                    torch.from_numpy(vel[i]), float(mass[i]),
                                    int(ptype[i]), float(temp[i]))
        assert int(gp) == int(rp)
        return int(gp)

    def add_batch(lo, hi):
        nonlocal ref, got
        ref, rids = jsys.add_particles_batch(ref, pos[lo:hi], vel[lo:hi],
                                             mass[lo:hi], ptype[lo:hi],
                                             temp[lo:hi])
        got, gids = psys.add_particles_batch(
            got, *(torch.from_numpy(x[lo:hi]) for x in
                   (pos, vel, mass, ptype, temp)))
        np.testing.assert_array_equal(gids.numpy(), np.asarray(rids))

    assert [add_one(i) for i in range(3)] == [1, 2, 3]
    _assert_pools_equal(got, ref)
    if op == "add":
        add_batch(3, 6)
        _assert_pools_equal(got, ref)
    elif op == "overflow":
        add_batch(3, 8)
        _assert_pools_equal(got, ref)
        assert add_one(8) == -1  # full: the pool is unchanged
        _assert_pools_equal(got, ref)
    elif op == "find_remove":
        add_batch(3, 6)
        for pid in (1, 4, 6, 7, 0):
            assert (int(psys.find_particle(got, pid))
                    == int(jsys.find_particle(ref, pid)))
        got, ref = psys.remove_particle(got, 4), jsys.remove_particle(ref, 4)
        _assert_pools_equal(got, ref)
        assert int(psys.find_particle(got, 4)) == -1
    elif op == "compaction":
        add_batch(3, 7)
        for pid in (2, 5):
            got = psys.remove_particle(got, pid)
            ref = jsys.remove_particle(ref, pid)
        for g, r in zip(psys.get_particle_data(got),
                        jsys.get_particle_data(ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(got.num_active()) == 5
    else:
        # A batch past the capacity: ids, count and next_id as in the JAX
        # package; every kept row in its own slot.  The JAX package
        # scatters the dropped rows onto the last slot too, which can
        # overwrite the last kept row, so that slot is held to the input.
        add_batch(3, 12)
        _assert_pools_equal(got, ref, skip_slots=[cap - 1])
        np.testing.assert_array_equal(got.position[cap - 1].numpy(),
                                      pos[cap - 1 - 3 + 3])
        assert bool(got.active.all()) and int(got.num_active()) == cap
        np.testing.assert_array_equal(got.pid.numpy(), np.arange(1, 9))


def test_particle_system_from_reference_carries_every_leaf():
    ref = jsys.ParticleSystem.create(6)
    ref, _ = jsys.add_particles_batch(ref, *(jnp.asarray(x) for x in
                                             _rows(1, 4)))
    got = psys.particle_system_from_reference(ref, "cpu")
    _assert_pools_equal(got, ref)
    assert got.count.shape == () and got.count.dtype == torch.int32


def _records(spin=0.9):
    bh = (jtypes.BlackHole.create(1.0, spin),
          types.BlackHole.create(1.0, spin, device="cpu"))
    disk = (jtypes.Disk.create(6.0, 20.0, 1.5, 1.0),
            types.Disk.create(6.0, 20.0, 1.5, 1.0, device="cpu"))
    return bh, disk


@pytest.mark.parametrize("which", ["accretion_disk", "hawking"])
def test_generator_transforms_match_jax_key_schedule(which):
    (jbh, bh), (jdisk, disk) = _records()
    n = 257
    key = jax.random.PRNGKey(11)
    # The JAX generators' own draws: split(key, 3), then their uniforms.
    k1, k2, k3 = jax.random.split(key, 3)
    if which == "accretion_disk":
        draws = (jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,)),
                 jax.random.uniform(k3, (n, 3)))
        ref = jgen.accretion_disk_particles(key, n, jbh, jdisk)
        got = generators.accretion_disk_transform(
            *(torch.from_numpy(np.array(u)) for u in draws), bh, disk)
    else:
        draws = (jax.random.uniform(k1, (n,), minval=-1.0, maxval=1.0),
                 jax.random.uniform(k2, (n,)),
                 jax.random.uniform(k3, (n, 3)))
        ref = jgen.hawking_radiation_particles(key, n, jbh, 1.5)
        got = generators.hawking_transform(
            *(torch.from_numpy(np.array(u)) for u in draws), bh, 1.5)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("which", ["accretion_disk", "hawking"])
def test_generators_sample_from_a_torch_generator(which):
    _, (_, disk) = _records()
    (_, bh), _ = _records()
    pool = psys.ParticleSystem.create(64, device="cpu")

    def seeded():
        return torch.Generator().manual_seed(5)

    if which == "accretion_disk":
        new, ids = generators.create_accretion_disk(pool, seeded(), 40, bh,
                                                    disk)
        again, _ = generators.create_accretion_disk(pool, seeded(), 40, bh,
                                                    disk)
        r = torch.linalg.vector_norm(new.position[:40, :2], dim=-1)
        assert float(r.min()) >= 6.0 - 1e-5 and float(r.max()) <= 20.0 + 1e-5
        assert (new.ptype[:40] == psys.ParticleType.DISK).all()
    else:
        new, ids = generators.generate_hawking_radiation(pool, seeded(), 40,
                                                         bh)
        again, _ = generators.generate_hawking_radiation(pool, seeded(), 40,
                                                         bh)
        r = torch.linalg.vector_norm(new.position[:40], dim=-1)
        torch.testing.assert_close(r, torch.full((40,), 2.02), rtol=1e-5,
                                   atol=0)
        speed = torch.linalg.vector_norm(new.velocity[:40], dim=-1)
        torch.testing.assert_close(speed, torch.full((40,), 0.9))
    assert ids.tolist() == list(range(1, 41))
    assert torch.equal(new.position, again.position)


def _mixed_pool():
    """64 particles: TEST particles inside 20 r_s on perturbed circular
    orbits, DISK particles, a far TEST particle (Newtonian) and one TEST
    particle falling in from 2.02 M at theta = 1 rad that the geodesic
    step takes to r = 1.92 M < r_s: captured in the first step."""
    rng = np.random.default_rng(3)
    n_test, n_disk = 40, 21
    r = rng.uniform(6.0, 36.0, n_test)
    ph = rng.uniform(0, 2 * np.pi, n_test)
    z = rng.uniform(-2.0, 2.0, n_test)
    pos_t = np.stack([r * np.cos(ph), r * np.sin(ph), z], -1)
    v = np.sqrt(1.0 / r)
    vel_t = np.stack([-np.sin(ph) * v, np.cos(ph) * v, np.zeros(n_test)], -1)
    vel_t *= rng.uniform(0.8, 1.1, (n_test, 1))
    rd = rng.uniform(8.0, 30.0, n_disk)
    phd = rng.uniform(0, 2 * np.pi, n_disk)
    pos_d = np.stack([rd * np.cos(phd), rd * np.sin(phd),
                      np.zeros(n_disk)], -1)
    vel_d = np.stack([-np.sin(phd), np.cos(phd), np.zeros(n_disk)],
                     -1) * np.sqrt(1.0 / rd)[:, None]
    fall = np.array([np.sin(1.0), 0.0, np.cos(1.0)])
    pos = np.concatenate([pos_t, pos_d, [[60.0, 0.0, 5.0],
                                         2.02 * fall]]).astype(F32)
    vel = np.concatenate([vel_t, vel_d, [[0.0, 0.12, 0.0],
                                         -0.6 * fall]]).astype(F32)
    ptype = np.array([0] * n_test + [1] * n_disk + [0, 0], np.int32)
    ref = jsys.ParticleSystem.create(64)
    ref, _ = jsys.add_particles_batch(ref, jnp.asarray(pos), jnp.asarray(vel),
                                      jnp.zeros(63), jnp.asarray(ptype))
    return ref


@pytest.mark.parametrize("steps", [1, 20])
def test_update_particles_matches_jax(steps):
    jbh = jtypes.BlackHole.create(1.0, 0.9)
    jcfg = jtypes.SimConfig.create(time_step=0.1)
    bh = types.BlackHole.create(1.0, 0.9, device="cpu")
    cfg = types.SimConfig.create(time_step=0.1, device="cpu")
    ref = _mixed_pool()
    got = psys.particle_system_from_reference(ref, "cpu")
    # The geodesic branch runs for the 40 orbiting TEST particles and the
    # falling one; the far TEST particle and the DISK ones are Newtonian.
    use_geo = dynamics.regimes(got, bh) & got.active
    assert int(use_geo.sum()) == 41
    jstep = jax.jit(jdyn.update_particles)
    for _ in range(steps):
        ref = jstep(ref, jbh, jcfg)
        got = dynamics.update_particles(got, bh, cfg)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    assert not bool(got.active[62])  # captured in the first step
    assert int(got.num_active()) == 62
    for name in ("position", "velocity"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("age", "time_dilation"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, err_msg=name)


def test_orbits_match_jax():
    rng = np.random.default_rng(9)
    pos = (rng.normal(size=(64, 3)) * 20).astype(F32)
    vel = (rng.normal(size=(64, 3)) * 0.2).astype(F32)
    got = orbits.orbit_parameters(torch.from_numpy(pos),
                                  torch.from_numpy(vel), 1.0)
    ref = jorbits.orbit_parameters(jnp.asarray(pos), jnp.asarray(vel), 1.0)
    for name, g, r in zip(ref._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    r = rng.uniform(2.0, 60.0, 16).astype(F32)
    bh = types.BlackHole.create(1.0, 0.7, device="cpu")
    jbh = jtypes.BlackHole.create(1.0, 0.7)
    v, ok = orbits.circular_orbit_velocity(torch.from_numpy(r), bh)
    jv, jok = jorbits.circular_orbit_velocity(jnp.asarray(r), jbh)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(
        orbits.orbital_period(torch.from_numpy(r), 1.0).numpy(),
        np.asarray(jorbits.orbital_period(jnp.asarray(r), 1.0)), rtol=1e-6)


def test_particle_step_gate_runs_on_cpu():
    """chip_smoke phase 17c's pool and its card-against-CPU step gate,
    with a CPU context on both sides: a pool seeded as the phase seeds
    it, stepped, passes with no gap; a step of 1.001 times the time step
    on one side fails it."""
    import dataclasses

    import chip_smoke

    context = chip_smoke.api_context("cpu", bench=True)
    system = chip_smoke.seed_pool(context, 500,
                                  torch.Generator().manual_seed(2))
    assert int(system.num_active()) == 400
    assert int((dynamics.regimes(system, context.blackhole)
                & system.active).sum()) == 100
    for _ in range(3):
        system = dynamics.update_particles(system, context.blackhole,
                                           context.config)
    stats = chip_smoke.step_card_vs_cpu(system, context, context, stride=8)
    assert stats["sample"] == 63 and stats["position_gap_max"] == 0.0
    other = chip_smoke.api_context("cpu", bench=True)
    other.config = dataclasses.replace(
        other.config, time_step=other.config.time_step * 1.001)
    with pytest.raises(AssertionError, match="card against CPU"):
        chip_smoke.step_card_vs_cpu(system, other, context, stride=8)
