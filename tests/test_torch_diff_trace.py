"""Reverse mode through the PyTorch port's checkpointed trace.

grad.diff_trace against the JAX package's, float64 on the same scene
and camera (the JAX package's gradient tests' small scene): the
differentiable render's forward equals the port's own XLA-engine render
(the extra masked steps move frozen rays by ulps only), and its
d(mean image)/d(mass, spin) by .backward() is jax.grad's within rtol
1e-6, with the hard shadow edge and with the soft one (softness 0.3:
the capture margin and the crossing-opacity planes carry gradient).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import diff_trace
from blackhole_tpu_torch.render import image

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py

F64 = torch.float64


def small_case(spin=0.5, softness=0.0, max_steps=150):
    scene = jtypes.Scene(
        blackhole=jtypes.BlackHole.create(1.0, spin, dtype=jnp.float64),
        disk=jtypes.Disk.create(6.0, 20.0, dtype=jnp.float64),
        config=jtypes.SimConfig.create(
            time_step=0.1, max_ray_distance=80.0, max_steps=max_steps,
            shadow_softness=softness, dtype=jnp.float64),
        disk_enabled=True,
    )
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0,
                                  dtype=jnp.float64)
    return (scene, camera, scene_from_reference(scene, "cpu", F64),
            camera_from_reference(camera, "cpu", F64))


def test_diff_forward_matches_xla_render():
    """render_image_diff (exactly max_steps masked steps, checkpointed)
    against render_image(engine="xla") (early exit), 16x16, f64."""
    _, _, scene, camera = small_case()
    img = image.render_image(scene, camera, 16, 16, engine="xla")
    diff = diff_trace.render_image_diff(scene, camera, 16, 16)
    assert diff.dtype == F64 and diff.shape == (16, 16, 3)
    np.testing.assert_allclose(diff.numpy(), img.numpy(), atol=1e-10)
    # Other segment counts run the same steps.
    again = diff_trace.render_image_diff(scene, camera, 16, 16, segments=7)
    np.testing.assert_allclose(again.numpy(), diff.numpy(), atol=1e-12)


SOFTNESS = {"hard": 0.0, "soft": 0.3}


@pytest.mark.parametrize("softness", list(SOFTNESS.values()),
                         ids=list(SOFTNESS))
def test_render_image_diff_grad_matches_jax(softness, request):
    """d(mean image)/d(mass, spin) at 8x8, 150 steps, float64: .backward()
    through render_image_diff against jax.grad of the JAX package's
    (recorded once: tests/jax_refs.py, case diff_trace_grad)."""
    _, _, scene, camera = small_case(softness=softness)
    rec = jax_refs.load("diff_trace_grad")
    key = request.node.callspec.id
    want = (rec[f"{key}.mass"], rec[f"{key}.spin"])
    m = torch.tensor(1.0, dtype=F64, requires_grad=True)
    s = torch.tensor(0.5, dtype=F64, requires_grad=True)
    bh = dataclasses.replace(scene.blackhole, mass=m, spin=s)
    diff_trace.render_image_diff(dataclasses.replace(scene, blackhole=bh),
                                 camera, 8, 8).mean().backward()
    for got, ref in ((m.grad, want[0]), (s.grad, want[1])):
        assert np.isfinite(float(got)) and float(ref) != 0.0
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_frozen_lane_overflow_leaves_the_gradient_finite(monkeypatch):
    """Three rays of the bench scene's 1024x1024 image (float32) that are
    captured (two) or hit the disk and then sit frozen while the masked
    trial steps from their state overflow: the mask's zero cotangent
    meets an infinite partial derivative there, 0 * inf = NaN.  The
    carry's cotangent guard zeroes such a ray's state cotangent, as in
    the JAX package, and diff_trace's per-ray scene (_PerRay) its share
    of the scene's: the gradient is finite.  Without the per-ray scene
    the NaN reaches d/d(mass, spin), as it does in the JAX package."""
    import chip_smoke
    from blackhole_tpu_torch.render import camera as cam

    scene, camera = chip_smoke.bench_scene(torch.device("cpu"))
    scene = dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, max_steps=300))
    o, d = cam.generate_rays(camera, 1024, 1024)
    idx = torch.tensor([44546, 49666, 108033])
    o, d = o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx]

    def grads():
        m = torch.tensor(1.0, requires_grad=True)
        s = torch.tensor(0.9, requires_grad=True)
        sc = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m, spin=s))
        hit = diff_trace.trace_rays_diff(o, d, sc)
        assert hit.result.tolist() == [0, 0, 1]
        return [float(g) for g in torch.autograd.grad(hit.color.sum(),
                                                      [m, s])]

    assert all(np.isfinite(grads()))
    monkeypatch.setattr(diff_trace, "_per_ray", lambda sc, n: sc)
    assert not any(np.isfinite(grads()))
