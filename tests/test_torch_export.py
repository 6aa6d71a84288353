"""torch.export artifacts of the PyTorch port (blackhole_tpu_torch.export)
against the port's live calls and the JAX package's deserialised
jax.export artifacts, on the cases of tests/test_export.py.

Each artifact is held bit for bit to the port's live call on the same
inputs (trace_kernel.trace_rays_kernel: K1's plain version on the CPU),
and under the RK4 colour contract (max < 2e-4; tools/tpu_parity.py) to
JAX's artifact, which exports the XLA engine, called on the same
inputs.  The program records the registered K1 operator.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu import export as jexport
from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.render import camera as jcam
from blackhole_tpu_torch import export as bx
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import trace_kernel

torch.set_num_threads(1)  # see tests/test_torch_step.py

RK4_COLOR_MAX = 2e-4


def _jscene(mass=1.0, spin=0.5):
    return jtypes.Scene(
        blackhole=jtypes.BlackHole.create(mass, spin),
        disk=jtypes.Disk.create(6.0, 20.0),
        config=jtypes.SimConfig.create(
            time_step=0.1, max_ray_distance=60.0, max_steps=80
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


def test_graph_calls_the_k1_operator_and_leapfrog_raises(trace64):
    exported, _ = trace64
    code = exported.graph_module.code
    assert "torch.ops.blackhole_tpu_torch.trace_planes.default" in code
    leap = _port(dataclasses.replace(_jscene(), config=dataclasses.replace(
        _jscene().config, integrator="leapfrog")))
    for export_call in (lambda: bx.export_trace(leap, n_rays=64),
                        lambda: bx.export_render(
                            leap, camera_from_reference(_jcamera(), "cpu"),
                            4, 4)):
        with pytest.raises(ValueError, match="RK4 and RKF45"):
            export_call()
