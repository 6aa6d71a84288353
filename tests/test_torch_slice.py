"""The forward render slice of the PyTorch port against the JAX package.

trace_rays_kernel (on CPU tensors: the kernel's plain version) against
pallas_kernel.trace_rays_pallas in interpret mode, and render_image
against the JAX render_image, on the same float32 rays and scenes,
under the parity contracts of the JAX package's compiled-kernel checks:
  RK4: result codes and steps equal, colour max < 2e-4 over agreeing
    rays that are not MAX_STEPS;
  RKF45: at most n/500 result codes differ, colour mean < 2e-3 and
    p99 < 3e-2 over agreeing non-MAX_STEPS rays (the accept/reject
    cascade turns ulp-level differences into other step sequences).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import image as jimage
from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.geom.types import (
    RayResult, camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.render import image, trace_kernel

torch.set_num_threads(1)  # see tests/test_torch_step.py


def _case(spin, disk, integrator="rk4", max_steps=250, time_step=0.1,
          max_dist=80.0, size=32):
    scene = jtypes.Scene(
        jtypes.BlackHole.create(1.0, spin),
        jtypes.Disk.create(6.0, 20.0),
        jtypes.SimConfig.create(time_step=time_step,
                                max_ray_distance=max_dist,
                                max_steps=max_steps, integrator=integrator),
        disk_enabled=disk,
    )
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0)
    o, d = jcam.generate_rays(camera, size, size)
    return (scene, camera, np.asarray(o, np.float32).reshape(-1, 3),
            np.asarray(d, np.float32).reshape(-1, 3))


def _assert_contract(res, res_ref, color, color_ref, adaptive):
    agree = res == res_ref
    dc = np.abs(color - color_ref).max(-1)
    mask = agree & (res_ref != RayResult.MAX_STEPS)
    dc = dc[mask] if mask.any() else dc
    if adaptive:
        assert np.sum(~agree) <= max(1, res.size // 500)
        assert dc.mean() < 2e-3 and np.percentile(dc, 99) < 3e-2
    else:
        np.testing.assert_array_equal(res, res_ref)
        assert dc.max() < 2e-4


def _trace_both(scene, o, d):
    ref = pallas_kernel.trace_rays_pallas(jnp.asarray(o), jnp.asarray(d),
                                          scene, interpret=True)
    got = trace_kernel.trace_rays_kernel(torch.from_numpy(o),
                                         torch.from_numpy(d),
                                         scene_from_reference(scene,
                                                              device="cpu"))
    return got, ref


@pytest.mark.parametrize(
    "spin,disk,time_step",
    [(0.0, True, 0.1), (0.9, True, 0.1), (0.9, False, 0.1), (0.9, True, 0.5)],
    ids=["schw-disk", "kerr-disk", "kerr-no-disk", "kerr-disk-wide-step"],
)
def test_trace_rays_kernel_rk4_matches_pallas(spin, disk, time_step):
    scene, _, o, d = _case(spin, disk, time_step=time_step)
    got, ref = _trace_both(scene, o, d)
    res = got.result.numpy()
    assert res.dtype == np.int32 and got.color.shape == (1024, 3)
    _assert_contract(res, np.asarray(ref.result), got.color.numpy(),
                     np.asarray(ref.color), adaptive=False)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    # Termination points: float32 chords summed over up to 250 steps.
    # Rays that came within 3M of the hole crossed the stiff near-horizon
    # zone, where an ulp can become any length (at the wide step a ray can
    # be catapulted out): compared for the other rays only.
    keep = np.asarray(ref.min_r) > 3.0
    np.testing.assert_allclose(got.distance.numpy()[keep],
                               np.asarray(ref.distance)[keep], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got.position.numpy()[keep],
                               np.asarray(ref.position)[keep], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got.min_r.numpy()[keep],
                               np.asarray(ref.min_r)[keep], rtol=1e-5)
    if time_step == 0.5:  # the wide step reaches captures and the budget
        assert {RayResult.HORIZON, RayResult.DISK,
                RayResult.MAX_DISTANCE} <= set(res.tolist())


def test_outward_rays_escape_like_pallas():
    """Rays from the camera pointing away from the hole reach
    max_ray_distance in radius before path length: BACKGROUND.  (Rays
    that pass the hole first run out of path budget, MAX_DISTANCE.)"""
    scene, _, o, d = _case(0.9, True, max_steps=250, time_step=0.5)
    o, d = o[::16], -d[::16]
    got, ref = _trace_both(scene, o, d)
    assert set(np.asarray(ref.result).tolist()) == {RayResult.BACKGROUND}
    _assert_contract(got.result.numpy(), np.asarray(ref.result),
                     got.color.numpy(), np.asarray(ref.color), adaptive=False)


@pytest.mark.parametrize("spin,disk", [(0.9, True), (0.0, False)])
def test_trace_rays_kernel_rkf45_matches_pallas(spin, disk):
    scene, _, o, d = _case(spin, disk, "rkf45", max_steps=192)
    got, ref = _trace_both(scene, o, d)
    _assert_contract(got.result.numpy(), np.asarray(ref.result),
                     got.color.numpy(), np.asarray(ref.color), adaptive=True)


def test_trace_rays_kernel_non_tile_batch():
    """777 rays (not a multiple of any tile) keep their batch shape."""
    scene, _, o, d = _case(0.9, True, max_steps=100)
    o, d = o[:777], d[:777]
    got, ref = _trace_both(scene, o, d)
    assert got.result.shape == (777,) and got.color.shape == (777, 3)
    _assert_contract(got.result.numpy(), np.asarray(ref.result),
                     got.color.numpy(), np.asarray(ref.color), adaptive=False)
    # Batch shape (..., 3) round-trips too.
    hit = trace_kernel.trace_rays_kernel(
        torch.from_numpy(o[:776]).reshape(8, 97, 3),
        torch.from_numpy(d[:776]).reshape(8, 97, 3),
        scene_from_reference(scene, device="cpu"),
    )
    assert hit.result.shape == (8, 97) and hit.position.shape == (8, 97, 3)
    np.testing.assert_array_equal(hit.result.numpy().reshape(-1),
                                  got.result.numpy()[:776])


@pytest.mark.parametrize("integrator,max_steps", [("rk4", 250),
                                                  ("rkf45", 192)])
def test_render_image_matches_jax(integrator, max_steps):
    """render_image with 2 Halton-jittered samples per pixel, against the
    JAX render_image (its XLA engine on the CPU).  RK4: every pixel
    within 2e-4; RKF45: the contract's colour statistics per pixel."""
    scene, camera, _, _ = _case(0.9, True, integrator, max_steps)
    ref = np.asarray(jimage.render_image(scene, camera, 32, 32, spp=2))
    got = image.render_image(scene_from_reference(scene, device="cpu"),
                             camera_from_reference(camera, device="cpu"),
                             32, 32, spp=2)
    assert got.shape == (32, 32, 3) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    dc = np.abs(got.numpy() - ref).max(-1)
    if integrator == "rk4":
        assert dc.max() < 2e-4
    else:
        assert dc.mean() < 2e-3 and np.percentile(dc, 99) < 3e-2


def test_depth_sorted_trace_equals_raster():
    """Regrouping rays by predicted depth leaves every ray's result
    unchanged: the kernel's per-ray arithmetic is position-independent."""
    scene, camera, o, d = _case(0.9, True, max_steps=150)
    tscene = scene_from_reference(scene, device="cpu")
    order = image.predicted_depth_order(
        tscene, camera_from_reference(camera, device="cpu"), 32, 32, block=4)
    assert sorted(order.tolist()) == list(range(1024))
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    raster = trace_kernel.trace_rays_kernel(o, d, tscene)
    ordered = trace_kernel.trace_rays_kernel(o, d, tscene, order=order)
    for f in dataclasses.fields(raster):
        assert torch.equal(getattr(raster, f.name),
                           getattr(ordered, f.name)), f.name


def test_predicted_depth_order_matches_jax():
    scene, camera, _, _ = _case(0.9, True, max_steps=150)
    ref = np.asarray(jimage.predicted_depth_order(scene, camera, 32, 30,
                                                  block=4, interpret=True))
    got = image.predicted_depth_order(
        scene_from_reference(scene, device="cpu"),
        camera_from_reference(camera, device="cpu"), 32, 30, block=4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unported_paths_raise():
    scene, _, o, d = _case(0.9, True, max_steps=20)
    o, d = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    tscene = scene_from_reference(scene, device="cpu")
    # Only "auto" and "xla" are engines; the kernel itself takes RK4 and
    # RKF45 only (the symplectic integrators go to the XLA engine).
    with pytest.raises(ValueError):
        image.trace_rays_fast(o, d, tscene, engine="pallas")
    with pytest.raises(ValueError):
        trace_kernel.trace_rays_kernel(o, d, dataclasses.replace(
            tscene, config=dataclasses.replace(tscene.config,
                                               integrator="leapfrog")))
    # Forward mode only: reverse mode through the loop raises (at
    # .backward(), since the planes pass is an autograd Function whose
    # forward-mode rule is ported) instead of returning a silent zero.
    mass = tscene.blackhole.mass.clone().requires_grad_(True)
    hit = trace_kernel.trace_rays_kernel(o, d, dataclasses.replace(
        tscene, blackhole=dataclasses.replace(tscene.blackhole, mass=mass)))
    with pytest.raises(NotImplementedError):
        hit.color.sum().backward()


def test_launch_node_sees_plain_tensors_and_refuses_derivatives():
    """The node every CUDA launch runs in (trace_kernel._Launch), driven
    with a CPU stand-in for the kernel inside a forward-mode rule like
    _Planes': the launch receives tensors whose memory it can address
    under torch.func.jvp, the rule's tangent is right, and a derivative
    of the launch itself (forward over forward, reverse) raises instead
    of coming back as a silent zero."""
    def launch(x, dx, scale):
        x.data_ptr(), dx.data_ptr()  # raw pointers, as ctypes takes them
        return torch.stack([x * x, scale * x * dx])

    class Square(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return trace_kernel._Launch.apply(launch, x, torch.zeros_like(x),
                                              2.0)[0]

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0])

        @staticmethod
        def jvp(ctx, dx):
            (x,) = ctx.saved_tensors
            return trace_kernel._Launch.apply(launch, x, dx, 2.0)[1]

    x = torch.linspace(-1.0, 2.0, 5)
    y, dy = torch.func.jvp(Square.apply, (x,), (torch.ones(5),))
    np.testing.assert_array_equal(y.numpy(), (x * x).numpy())
    np.testing.assert_array_equal(dy.numpy(), (2.0 * x).numpy())

    def inner(x_):
        return torch.func.jvp(Square.apply, (x_,), (torch.ones(5),))[1]

    with pytest.raises(NotImplementedError):
        torch.func.jvp(inner, (x,), (torch.ones(5),))
    with pytest.raises(NotImplementedError):
        Square.apply(x.clone().requires_grad_(True)).sum().backward()


def test_temporal_accumulate_matches_jax():
    rng = np.random.default_rng(5)
    hist = rng.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    frame = rng.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    for idx in (0, 1, 2, 31, 32, 40):
        got, gi = image.temporal_accumulate(torch.from_numpy(hist),
                                            torch.from_numpy(frame), idx)
        ref, ri = jimage.temporal_accumulate(hist, frame, idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
        assert int(gi) == int(ri)
