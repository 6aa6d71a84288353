"""The port's bh_* API, particle facade and CLI on a CPU context.

Mirrors tests/test_api.py case for case (same names, a CPU context,
torch.Generator in place of jax.random keys), and holds the port to the
JAX package:

* bh_trace_rays_batch on the five canonical rays against the JAX API's
  call through the JAX package's geodesic kernel (engine
  "pallas_interpret", which its "auto" picks on a TPU, recorded once by
  tests/jax_refs.py; the port's "auto" on a CPU context is the CUDA
  kernel's plain version) under the
  RK4 contract: result codes and step counts equal, colour within 2e-4.
  Each ray's end point is held within END_RTOL of its length: rays 1, 3
  and 4 start on the polar axis and ray 2 (impact parameter 5.88 M)
  wraps the photon sphere, so float32 rounding moves their end points
  by up to 7 M from float64's in both packages, and by up to 2.5e-4 of
  their length between the packages (ray 2; ray 4: 2.1e-4).  In
  float64 (the XLA engine on both sides) every end point agrees within
  rtol 1e-5.
* bh_trace_ray (the XLA engine) bit for bit equal to the batch's ray
  through the same engine.
* bh_generate_shader_data, bh_calculate_time_dilation and
  bh_calculate_orbital_velocity within rtol 1e-6.
* cli tests: every output line equal to the JAX CLI's, numeric fields
  within 1e-3 (the printed precision), the end points' lines (hit
  position, distance) within 1e-3 plus END_RTOL of their scale, as
  above; cli render at 16x16, 200 steps, a PNG
  within 1/255 of the JAX render's; cli fit prints "fitted:".
"""

import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu import api as japi
from blackhole_tpu import cli as jcli
from blackhole_tpu_torch import api, cli
from blackhole_tpu_torch.geom.types import RayResult
from blackhole_tpu_torch.particles import orbits
from blackhole_tpu_torch.particles import system as psys
from blackhole_tpu_torch.viz import io as viz_io

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py

ORIGINS = np.array([r[0] for r in cli.TEST_RAYS])
DIRS = np.array([r[1] for r in cli.TEST_RAYS])
END_RTOL = 5e-4


def _configure(context):
    assert api.bh_configure_black_hole(context, 1.0, 0.0, 0.0) == 0
    assert api.bh_configure_accretion_disk(context, 6.0, 20.0, 1.0, 1.0) == 0
    assert api.bh_configure_simulation(context, 0.1, 100.0, 1000, 1e-6) == 0
    return context


def _jax_ctx(dtype=jnp.float32):
    context = japi.bh_initialize(dtype)
    assert japi.bh_configure_black_hole(context, 1.0, 0.0, 0.0) == 0
    assert japi.bh_configure_accretion_disk(context, 6.0, 20.0, 1.0, 1.0) == 0
    assert japi.bh_configure_simulation(context, 0.1, 100.0, 1000, 1e-6) == 0
    return context


@pytest.fixture
def ctx():
    return _configure(api.bh_initialize(device="cpu"))


@pytest.fixture(scope="module")
def five_rays():
    """(port Hit, JAX Hit) of the five rays through the geodesic kernel
    (the JAX one recorded once: tests/jax_refs.py)."""
    got = api.bh_trace_rays_batch(_configure(api.bh_initialize(device="cpu")),
                                  ORIGINS, DIRS)
    return got, jax_refs.hit(jax_refs.load("api_five_rays"))


def test_version():
    major, minor, patch = api.bh_get_version()
    assert (major, minor, patch) >= (0, 1, 0)
    assert api.bh_get_version() == japi.bh_get_version()


def test_config_validation():
    context = api.bh_initialize(device="cpu")
    assert api.bh_configure_black_hole(context, -1.0, 0.0) == \
        api.BHError.INVALID_PARAMETER
    assert api.bh_configure_black_hole(context, 1.0, 1.5) == \
        api.BHError.INVALID_PARAMETER
    assert api.bh_configure_accretion_disk(context, 6.0, 5.0, 1.0, 1.0) == \
        api.BHError.INVALID_PARAMETER
    assert api.bh_configure_simulation(context, -0.1, 100.0, 10, 1e-6) == \
        api.BHError.INVALID_PARAMETER
    # Bad keyword options return the error code too (never raise).
    assert api.bh_configure_simulation(
        context, 0.1, 100.0, 10, 1e-6, disk_kinematics="newtonian"
    ) == api.BHError.INVALID_PARAMETER
    assert api.bh_configure_simulation(
        context, 0.1, 100.0, 10, 1e-6, disk_kinematics="kerr"
    ) == api.BHError.SUCCESS
    assert context.config.disk_kinematics == "kerr"
    assert api.blackhole_get_mass(context) == 1.0
    assert context.config.time_step.device.type == "cpu"


def test_five_canonical_rays(ctx, five_rays):
    """The reference's 5 test rays with physically correct expectations:
    straight at the hole -> horizon; wide miss -> background; disk-angle
    shots -> disk."""
    hits, _ = five_rays
    results = hits.result.numpy()
    assert results[0] == RayResult.HORIZON
    assert results[2] in (RayResult.DISK, RayResult.BACKGROUND,
                          RayResult.MAX_DISTANCE)
    assert results[1] in (RayResult.DISK, RayResult.BACKGROUND,
                          RayResult.MAX_DISTANCE)
    assert results[3] == RayResult.DISK
    # Single-ray API agrees with the batch.
    h0 = api.bh_trace_ray(ctx, ORIGINS[0], DIRS[0])
    assert int(h0.result) == results[0]


def test_trace_rays_batch_matches_jax_api(five_rays):
    got, ref = five_rays
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(ref.result))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    assert np.abs(got.color.numpy() - np.asarray(ref.color)).max() < 2e-4
    ref_pos = np.asarray(ref.position)
    gap = np.linalg.norm(got.position.numpy() - ref_pos, axis=-1)
    assert np.all(gap <= END_RTOL * np.linalg.norm(ref_pos, axis=-1)), gap
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance),
                               rtol=END_RTOL)


def test_trace_rays_float64_and_trace_ray_match(five_rays):
    """Float64, the XLA engine on both sides: every end point (ray 2's
    too) within rtol 1e-5; bh_trace_ray bit for bit the batch's ray.
    Float32 puts rays 2 and 4 far from these end points in both
    packages, which is why END_RTOL bounds float32 per ray."""
    context = _configure(api.bh_initialize(torch.float64, device="cpu"))
    got = api.bh_trace_rays_batch(context, ORIGINS, DIRS, engine="xla")
    ref = japi.bh_trace_rays_batch(_jax_ctx(jnp.float64), ORIGINS, DIRS,
                                   engine="xla")
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(ref.result))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    for name in ("position", "distance", "color", "sky_direction"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    for p32 in (five_rays[0].position.numpy(),
                np.asarray(five_rays[1].position)):
        off = np.linalg.norm(p32 - np.asarray(ref.position), axis=-1)
        assert off[1] > 1.0 and off[3] > 0.1, off
    for i in (0, 3):
        one = api.bh_trace_ray(context, ORIGINS[i], DIRS[i])
        for name, value in vars(one).items():
            assert value.shape == getattr(got, name)[i].shape
            assert torch.equal(value, getattr(got, name)[i]), name


def test_orbital_velocity_table(ctx):
    """v = sqrt(M/r), as the JAX API gives it."""
    jctx = _jax_ctx()
    for r in (20.0, 30.0, 40.0, 50.0, 60.0):
        v = api.bh_calculate_orbital_velocity(ctx, r)
        np.testing.assert_allclose(v, np.sqrt(1.0 / r), rtol=1e-6)
        np.testing.assert_allclose(
            v, japi.bh_calculate_orbital_velocity(jctx, r), rtol=1e-6)
    with pytest.raises(ValueError):
        api.bh_calculate_orbital_velocity(ctx, -1.0)


def test_time_dilation_ratio(ctx):
    ratio = api.bh_calculate_time_dilation(
        ctx, (3.0, 0.0, 0.0), (1000.0, 0.0, 0.0)
    )
    expect = (1 / np.sqrt(1 - 2 / 3)) / (1 / np.sqrt(1 - 2 / 1000))
    np.testing.assert_allclose(ratio, expect, rtol=1e-5)
    jctx = _jax_ctx()
    for r in (2.5, 3.0, 5.0, 10.0, 100.0):
        np.testing.assert_allclose(
            api.bh_calculate_time_dilation(ctx, (r, 0.0, 0.0),
                                           (1000.0, 0.0, 0.0)),
            japi.bh_calculate_time_dilation(jctx, (r, 0.0, 0.0),
                                            (1000.0, 0.0, 0.0)),
            rtol=1e-6)


def test_particle_system_lifecycle(ctx):
    system = api.bh_create_particle_system(ctx, 64)
    assert system.capacity == 64 and system.position.device.type == "cpu"
    system, pid = api.bh_add_test_particle(
        ctx, system, (30.0, 0.0, 0.0), (0.0, 0.18, 0.0), 1e-6
    )
    assert int(pid) == 1
    system, n_disk = api.bh_create_accretion_disk_particles(
        ctx, system, 32, generator=torch.Generator().manual_seed(0)
    )
    assert n_disk == 32
    system, n_hawking = api.bh_generate_hawking_radiation(
        ctx, system, 8, generator=torch.Generator().manual_seed(1)
    )
    assert n_hawking == 8
    assert int(system.num_active()) == 41

    for _ in range(5):
        system = api.bh_update_particles(ctx, system)
    pos, vel, types, count = api.bh_get_particle_data(ctx, system)
    assert int(count) <= 41
    active_pos = pos[: int(count)].numpy()
    assert np.all(np.isfinite(active_pos))

    # Disk particles stay within ~the disk annulus after a few steps.
    types_np = types[: int(count)].numpy()
    radii = np.linalg.norm(active_pos, axis=-1)
    disk_r = radii[types_np == psys.ParticleType.DISK]
    assert np.all(disk_r > 2.0) and np.all(disk_r < 40.0)


def test_particle_pool_overflow(ctx):
    system = api.bh_create_particle_system(ctx, 4)
    system, n = api.bh_create_accretion_disk_particles(ctx, system, 10)
    assert n == 4  # clamped to the capacity, like the C pool
    system, pid = api.bh_add_test_particle(
        ctx, system, (30.0, 0.0, 0.0), (0.0, 0.1, 0.0), 0.0
    )
    assert int(pid) == -1


def test_remove_and_find_particle(ctx):
    system = api.bh_create_particle_system(ctx, 8)
    system, pid = api.bh_add_test_particle(
        ctx, system, (30.0, 0.0, 0.0), (0.0, 0.1, 0.0), 0.0
    )
    assert int(psys.find_particle(system, pid)) == 0
    system = psys.remove_particle(system, pid)
    assert int(psys.find_particle(system, pid)) == -1
    assert int(system.num_active()) == 0


def test_circular_orbit_is_stable():
    """A test particle on a circular orbit at r = 30 M keeps its radius
    over many geodesic steps (validates the timelike integrator)."""
    from blackhole_tpu_torch.geom.types import BlackHole
    from blackhole_tpu_torch.particles import dynamics

    bh = BlackHole.create(1.0, 0.0, dtype=torch.float64, device="cpu")
    pos = torch.tensor([[30.0, 0.0, 0.0]], dtype=torch.float64)
    vel, exists = orbits.circular_orbit_velocity(
        torch.tensor(30.0, dtype=torch.float64), bh
    )
    assert bool(exists)
    vel = vel[None, :]
    for _ in range(50):
        pos, vel = dynamics.geodesic_update(pos, vel, 0.5, bh.mass, bh.a)
    r = float(torch.linalg.vector_norm(pos[0]))
    assert abs(r - 30.0) < 0.5  # < 2% drift over 25 M of proper time


def test_orbit_parameters_circular():
    pos = torch.tensor([30.0, 0.0, 0.0])
    vel = torch.tensor([0.0, float(np.sqrt(1.0 / 30.0)), 0.0])
    p = orbits.orbit_parameters(pos, vel, 1.0)
    np.testing.assert_allclose(float(p.eccentricity), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(p.semi_major_axis), 30.0, rtol=1e-6)
    np.testing.assert_allclose(float(p.specific_energy), -1.0 / 60.0,
                               rtol=1e-6)


def test_shader_data_block(ctx):
    args = ((0.0, 0.0, 50.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 640, 480,
            60.0)
    blk = api.bh_generate_shader_data(ctx, *args)
    assert blk.shape == (31,)  # 5 bh + 4 disk + 9 observer + 2 camera
    #                            + 3 flags + 4 integration + 4 padding
    assert blk.dtype == np.float32
    assert blk[0] == 1.0  # mass
    assert blk[2] == 2.0  # rs
    np.testing.assert_allclose(blk[18], np.radians(60.0))
    np.testing.assert_allclose(blk[19], 640 / 480)
    jctx = _jax_ctx()
    np.testing.assert_allclose(blk, japi.bh_generate_shader_data(jctx, *args),
                               rtol=1e-6)
    for context, jcontext in ((ctx, jctx),):
        for spin in (0.5, 0.9):
            api.bh_configure_black_hole(context, 1.3, spin)
            japi.bh_configure_black_hole(jcontext, 1.3, spin)
            np.testing.assert_allclose(
                api.bh_generate_shader_data(context, *args, show_disk=False),
                japi.bh_generate_shader_data(jcontext, *args,
                                             show_disk=False), rtol=1e-6)


def test_context_from_reference():
    jctx = _jax_ctx()
    japi.bh_configure_black_hole(jctx, 1.2, 0.7, 0.1)
    context = api.context_from_reference(jctx, "cpu")
    assert context.disk_enabled and context.dtype == torch.float32
    assert context.device == torch.device("cpu")
    assert float(context.blackhole.spin) == float(jctx.blackhole.spin)
    assert context.config.max_steps == 1000


def _cli_out(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) in (0, None)
    return buf.getvalue().splitlines()


_NUM = re.compile(r"-?\d+\.\d+|-?\d+")


def test_cli_runs():
    out = _cli_out(cli.main, ["tests", "--device", "cpu"])
    text = "\n".join(out)
    assert "API Version" in text
    assert "Ray 5" in text
    assert "Orbital Velocity" in text
    assert "Tests completed." in text
    ref = _cli_out(jcli.main, ["tests"])
    assert len(out) == len(ref)
    for got_line, ref_line in zip(out, ref):
        assert _NUM.sub("#", got_line) == _NUM.sub("#", ref_line)
        got_nums = [float(x) for x in _NUM.findall(got_line)]
        ref_nums = [float(x) for x in _NUM.findall(ref_line)]
        atol = 1e-3
        if got_line.strip().startswith(("Hit position", "Distance")):
            atol += END_RTOL * max(map(abs, ref_nums))
        np.testing.assert_allclose(got_nums, ref_nums, rtol=0, atol=atol,
                                   err_msg=got_line)


def test_cli_render_matches_jax(tmp_path):
    argv = ["render", "--width", "16", "--height", "16", "--steps", "200"]
    got = tmp_path / "port.png"
    ref = tmp_path / "jax.png"
    _cli_out(cli.main, argv + ["--out", str(got), "--device", "cpu"])
    _cli_out(jcli.main, argv + ["--out", str(ref)])
    a, b = viz_io.read_image(str(got)), viz_io.read_image(str(ref))
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a - b).max() <= 1.0 / 255 + 1e-7


def test_cli_fit_prints_fitted():
    out = _cli_out(cli.main, ["fit", "--size", "4", "--steps", "60",
                              "--fit-steps", "2", "--device", "cpu"])
    assert out[0] == "target: mass=1.0 spin=0.5"
    assert out[-1].startswith("fitted: mass=")
