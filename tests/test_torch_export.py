"""torch.export artifacts of the PyTorch port (blackhole_tpu_torch.export)
against the port's live calls and the JAX package's deserialised
jax.export artifacts, on the cases of tests/test_export.py.

Each artifact is held bit for bit to the port's live call on the same
inputs (image.trace_rays_fast, which the artifact exports), and to
JAX's artifact, which exports the XLA engine, called on the same
inputs.  RK4 scenes export the geodesic kernel path (K1's plain version
on the CPU): the program records the registered K1 operator, under the
RK4 colour contract (max < 2e-4; tools/tpu_parity.py).  LEAPFROG and
YOSHIDA scenes export the port's XLA engine as a traced while_loop,
under the symplectic integrators' contract (tests/test_torch_xla_engine.py:
result codes and steps of the live Hits equal, colour max < 2e-4 over
the rays JAX's Hit does not mark MAX_STEPS); their scenes take 400
steps, so that rays end on the disk and at the horizon inside the loop.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu import export as jexport
from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import trace as jtrace
from blackhole_tpu_torch import export as bx
from blackhole_tpu_torch.geom.types import (
    RayResult, camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace_kernel

torch.set_num_threads(1)  # see tests/test_torch_step.py

RK4_COLOR_MAX = 2e-4


def _jscene(mass=1.0, spin=0.5, integrator="rk4", softness=0.0):
    """80 steps for RK4 (tests/test_export.py), 400 for the XLA engine's
    integrators."""
    return jtypes.Scene(
        blackhole=jtypes.BlackHole.create(mass, spin),
        disk=jtypes.Disk.create(6.0, 20.0),
        config=jtypes.SimConfig.create(
            time_step=0.1, max_ray_distance=60.0,
            max_steps=80 if integrator == "rk4" else 400,
            integrator=integrator, shadow_softness=softness,
        ),
        disk_enabled=True,
    )


def _jcamera():
    return jtypes.Camera.create(
        position=(0.0, -30.0, 8.0), direction=(0.0, 30.0, -8.0),
        up=(0.0, 0.0, 1.0), fov_deg=25.0,
    )


def _hot(jscene):
    """mass 1.3, spin 0.9, inner radius 7 (tests/test_export.py)."""
    return dataclasses.replace(
        jscene,
        blackhole=jtypes.BlackHole.create(1.3, 0.9),
        disk=dataclasses.replace(jscene.disk, inner_radius=jnp.float32(7.0)),
    )


def _rays(size):
    o, d = jcam.generate_rays(_jcamera(), size, size)
    return (np.array(o, np.float32).reshape(-1, 3),
            np.array(d, np.float32).reshape(-1, 3))


def _port(jscene):
    return scene_from_reference(jscene, "cpu")


def _check(got, live, jax_got):
    """Bit for bit the live call; the RK4 colour contract against JAX."""
    np.testing.assert_array_equal(got.numpy(), live.numpy())
    err = np.abs(got.numpy() - np.asarray(jax_got)).max()
    assert err < RK4_COLOR_MAX, err


@pytest.fixture(scope="module")
def trace64():
    """The 8x8 artifacts (n_rays=64) of both packages."""
    jscene = _jscene()
    return (bx.load(bx.export_trace(_port(jscene), n_rays=64)),
            jexport.load(jexport.export_trace(jscene, n_rays=64)))


def test_roundtrip_trace_matches_live(trace64):
    jscene = _jscene()
    blob = bx.export_trace(_port(jscene), n_rays=64)
    assert isinstance(blob, bytes) and len(blob) > 1000
    exported, jexported = trace64
    o, d = _rays(8)
    scene = _port(jscene)
    got = bx.call_trace(exported, scene, torch.from_numpy(o),
                        torch.from_numpy(d))
    live = trace_kernel.trace_rays_kernel(torch.from_numpy(o),
                                          torch.from_numpy(d), scene).color
    _check(got, live, jexport.call_trace(jexported, jscene, o, d))


def test_artifact_serves_new_scene_params(trace64):
    exported, jexported = trace64
    jhot = _hot(_jscene())
    o, d = _rays(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hot = _port(jhot)
    got = bx.call_trace(exported, hot, to, td)
    live = trace_kernel.trace_rays_kernel(to, td, hot).color
    _check(got, live, jexport.call_trace(jexported, jhot, o, d))
    base = bx.call_trace(exported, _port(_jscene()), to, td)
    assert (got - base).abs().max() > 1e-4


def test_poly_batch_accepts_any_ray_count():
    jscene = _jscene()
    scene = _port(jscene)
    exported = bx.load(bx.export_trace(scene, poly_batch=True))
    jexported = jexport.load(jexport.export_trace(jscene, poly_batch=True))
    for size in (4, 10):
        o, d = _rays(size)
        to, td = torch.from_numpy(o), torch.from_numpy(d)
        got = bx.call_trace(exported, scene, to, td)
        assert got.shape == (size * size, 3)
        live = trace_kernel.trace_rays_kernel(to, td, scene).color
        _check(got, live, jexport.call_trace(jexported, jscene, o, d))


def test_render_artifact_camera_is_runtime():
    jscene, jcamera = _jscene(), _jcamera()
    scene, camera = _port(jscene), camera_from_reference(jcamera, "cpu")
    exported = bx.load(bx.export_render(scene, camera, 12, 12))
    jexported = jexport.load(jexport.export_render(jscene, jcamera, 12, 12))
    moved_j = dataclasses.replace(
        jcamera, position=jnp.asarray([0.0, -40.0, 12.0], jnp.float32),
        direction=jnp.asarray([0.0, 40.0, -12.0], jnp.float32),
    )
    images = []
    for jc in (jcamera, moved_j):
        c = camera_from_reference(jc, "cpu")
        img = bx.call_render(exported, scene, c)
        assert img.shape == (12, 12, 3)
        o, d = cam.generate_rays(c, 12, 12)
        live = trace_kernel.trace_rays_kernel(
            o.reshape(-1, 3), d.reshape(-1, 3), scene).color.reshape(12, 12, 3)
        _check(img, live, jexport.call_render(jexported, jscene, jc))
        images.append(img)
    assert (images[1] - images[0]).abs().max() > 1e-3


def test_graph_calls_the_k1_operator(trace64):
    exported, _ = trace64
    code = exported.graph_module.code
    assert "torch.ops.blackhole_tpu_torch.trace_planes.default" in code
    assert "while_loop" not in code


def _check_xla(exported, got, live, jax_got, jhit):
    """The XLA engine's artifact: a traced while_loop and no K1 operator;
    bit for bit the live trace_rays_fast Hit's colour; that Hit's result
    codes and steps JAX's, and the colour within 2e-4 of JAX's
    artifact's over the rays JAX's Hit does not mark MAX_STEPS."""
    code = exported.graph_module.code
    assert "while_loop" in code and "trace_planes" not in code
    np.testing.assert_array_equal(got.numpy(), live.color.numpy())
    res_ref = np.asarray(jhit.result).reshape(-1)
    np.testing.assert_array_equal(live.result.numpy().reshape(-1), res_ref)
    np.testing.assert_array_equal(live.steps.numpy().reshape(-1),
                                  np.asarray(jhit.steps).reshape(-1))
    keep = res_ref != RayResult.MAX_STEPS
    assert keep.any() and (res_ref == RayResult.DISK).any()
    err = np.abs(got.numpy().reshape(-1, 3)
                 - np.asarray(jax_got).reshape(-1, 3))[keep].max()
    assert err < RK4_COLOR_MAX, err


@pytest.fixture(scope="module", params=["leapfrog", "yoshida"])
def xla64(request):
    """The 8x8 artifacts (n_rays=64) of both packages for a scene that
    trace_rays_fast sends to the XLA engine."""
    jscene = _jscene(integrator=request.param)
    return (jscene, bx.load(bx.export_trace(_port(jscene), n_rays=64)),
            jexport.load(jexport.export_trace(jscene, n_rays=64)))


def test_xla_engine_roundtrip_matches_live(xla64):
    jscene, exported, jexported = xla64
    o, d = _rays(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    scene = _port(jscene)
    got = bx.call_trace(exported, scene, to, td)
    _check_xla(exported, got, image.trace_rays_fast(to, td, scene),
               jexport.call_trace(jexported, jscene, o, d),
               jtrace.trace_rays(o, d, jscene))


def test_xla_engine_artifact_serves_new_scene_params(xla64):
    jscene, exported, jexported = xla64
    jhot = _hot(jscene)
    o, d = _rays(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hot = _port(jhot)
    got = bx.call_trace(exported, hot, to, td)
    _check_xla(exported, got, image.trace_rays_fast(to, td, hot),
               jexport.call_trace(jexported, jhot, o, d),
               jtrace.trace_rays(o, d, jhot))
    base = bx.call_trace(exported, _port(jscene), to, td)
    assert (got - base).abs().max() > 1e-4


def test_xla_engine_poly_batch_soft_yoshida():
    """A symbolic ray count (traced at 16 rays), called at 36 and 100;
    shadow_softness 0.3 carries the tracking fields through the loop and
    adds the capture margin."""
    jscene = _jscene(integrator="yoshida", softness=0.3)
    scene = _port(jscene)
    exported = bx.load(bx.export_trace(scene, poly_batch=True))
    jexported = jexport.load(jexport.export_trace(jscene, poly_batch=True))
    for size in (6, 10):
        o, d = _rays(size)
        to, td = torch.from_numpy(o), torch.from_numpy(d)
        got = bx.call_trace(exported, scene, to, td)
        assert got.shape == (size * size, 3)
        _check_xla(exported, got, image.trace_rays_fast(to, td, scene),
                   jexport.call_trace(jexported, jscene, o, d),
                   jtrace.trace_rays(o, d, jscene))


def test_xla_engine_render_artifact_camera_is_runtime():
    jscene, jcamera = _jscene(integrator="yoshida"), _jcamera()
    scene = _port(jscene)
    camera = camera_from_reference(jcamera, "cpu")
    exported = bx.load(bx.export_render(scene, camera, 12, 12))
    jexported = jexport.load(jexport.export_render(jscene, jcamera, 12, 12))
    moved_j = dataclasses.replace(
        jcamera, position=jnp.asarray([0.0, -40.0, 12.0], jnp.float32),
        direction=jnp.asarray([0.0, 40.0, -12.0], jnp.float32),
    )
    images = []
    for jc in (jcamera, moved_j):
        c = camera_from_reference(jc, "cpu")
        img = bx.call_render(exported, scene, c)
        assert img.shape == (12, 12, 3)
        o, d = cam.generate_rays(c, 12, 12)
        jo, jd = jcam.generate_rays(jc, 12, 12)
        _check_xla(exported, img.reshape(-1, 3),
                   image.trace_rays_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                         scene),
                   jexport.call_render(jexported, jscene, jc),
                   jtrace.trace_rays(jo.reshape(-1, 3), jd.reshape(-1, 3),
                                     jscene))
        images.append(img)
    assert (images[1] - images[0]).abs().max() > 1e-3
