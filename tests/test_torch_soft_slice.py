"""The soft-boundary render slice of the PyTorch port against the JAX package.

With shadow_softness > 0 and the disk on, the planes pass runs the
tracking variant of the geodesic kernel (K1-track; on CPU tensors its
plain version) and finalize composites the crossing opacity, the annulus
window and the survival sigmoid of the analytic capture margin.

* trace_rays_kernel against pallas_kernel.trace_rays_pallas in interpret
  mode (recorded once: tests/jax_refs.py, case soft_slice_trace) at the JAX package's soft-shadow engine-parity case
  (tests/test_pallas.py, test_pallas_soft_shadow_matches_while_loop: the
  32x32 parity camera, a = 0.9, disk on, 400 steps, path budget 80,
  softness 0.25) under its contract: result codes equal, min_r rtol
  3e-5, colour atol 2e-5; the tracking planes are live there.
* image.render_image of a soft scene against the JAX render_image (its
  XLA engine on the CPU) under test_torch_slice's RK4 render contract:
  every pixel within 2e-4.
* Depth-sorted traces equal raster ones bitwise with tracking, forward
  and forward-mode (K2-track).
"""

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from blackhole_tpu.render import image as jimage
from blackhole_tpu_torch.geom.types import (
    RayResult, camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace, trace_kernel

import jax_refs
from test_torch_fwdgrad_slice import P0, torch_params, torch_scene_fn
from test_torch_slice import _case
from test_torch_soft_grad import soft_case

torch.set_num_threads(1)  # see tests/test_torch_step.py


def _soft(scene, softness, **config):
    return dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, shadow_softness=softness, **config))


def test_trace_rays_kernel_soft_matches_pallas():
    scene, _, o, d = _case(0.9, True, max_steps=400)
    scene = _soft(scene, 0.25)
    tscene = scene_from_reference(scene, device="cpu")
    assert trace.track_crossing(tscene)
    ref = jax_refs.hit(jax_refs.load("soft_slice_trace"))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = trace_kernel.trace_rays_kernel(to, td, tscene)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(ref.result))
    np.testing.assert_allclose(got.min_r.numpy(), np.asarray(ref.min_r),
                               rtol=3e-5)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=2e-5)
    # The tracking planes are live: some non-disk rays passed the disk's
    # band on either side of the plane, and the crossing opacity changes
    # their colour.
    scal, inp = trace_kernel.prepare(to, td, tscene)
    out = trace_kernel.trace_planes(scal, inp, True, 400, False, True)
    assert out.shape == (trace_kernel.n_out(True), 1024)
    tracked = (out[15] < 1e9) & (out[0] != RayResult.DISK)
    assert bool((tracked & (out[18] > 0)).any())
    assert bool((tracked & (out[18] < 0)).any())
    margin = trace.compute_capture_margin(to, td, tscene)
    blind = out.clone()
    blind[15] = 1e9  # no approach recorded: no crossing opacity
    colors = [trace_kernel.postprocess(p, 1024, (1024,), tscene, None,
                                       inp[5], margin).color
              for p in (out, blind)]
    assert torch.equal(colors[0], got.color)
    assert int(((colors[0] - colors[1]).abs().amax(-1) > 1e-3).sum()) >= 5


def test_render_image_soft_matches_jax():
    scene, camera, _, _ = _case(0.9, True, max_steps=250)
    scene = _soft(scene, 0.3)
    ref = np.asarray(jimage.render_image(scene, camera, 24, 24))
    got = image.render_image(scene_from_reference(scene, device="cpu"),
                             camera_from_reference(camera, device="cpu"),
                             24, 24)
    assert got.shape == (24, 24, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_depth_sorted_soft_trace_equals_raster():
    """Forward (K1-track) and forward-mode (K2-track, a scene tangent and
    a ray tangent) traces in the depth order equal the raster ones
    bitwise; at the wide step the rays retire after different step
    counts, so the order is not the identity."""
    scene, camera, _, _ = _case(0.9, True, max_steps=60, time_step=0.5)
    tscene = scene_from_reference(_soft(scene, 0.3), device="cpu")
    tcamera = camera_from_reference(camera, device="cpu")
    o, d = cam.generate_rays(tcamera, 12, 12)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    order = image.predicted_depth_order(tscene, tcamera, 12, 12, block=1)
    assert not torch.equal(order, torch.arange(144))
    raster = trace_kernel.trace_rays_kernel(o, d, tscene)
    ordered = trace_kernel.trace_rays_kernel(o, d, tscene, order=order)
    for f in dataclasses.fields(raster):
        assert torch.equal(getattr(raster, f.name),
                           getattr(ordered, f.name)), f.name
    scene_fn = torch_scene_fn(tscene)
    tangents = [
        torch.func.jvp(lambda v: scene_fn(dict(zip(P0, v))),
                       (list(torch_params().values()),),
                       ([torch.tensor(1.0), torch.tensor(0.0)],))[1],
        (pytree.tree_map(torch.zeros_like, tscene),
         torch.tensor([0.0, 1.0, 0.0]).expand(144, 3), torch.zeros(144, 3)),
    ]
    raster = trace_kernel.trace_rays_kernel_fwdgrad(o, d, tscene, tangents)
    ordered = trace_kernel.trace_rays_kernel_fwdgrad(o, d, tscene, tangents,
                                                     order=order)
    for h_r, h_s in zip([raster[0], *raster[1]], [ordered[0], *ordered[1]]):
        for f in dataclasses.fields(h_r):
            assert torch.equal(getattr(h_r, f.name), getattr(h_s, f.name)), \
                f.name
    assert bool((raster[1][0].color != 0).any())


def test_plain_versions_share_their_arithmetic():
    """The plain version of K2 takes each tangent direction by its own
    torch.func.jvp of the same step: its primal equals K1-track's plain
    result, and its first direction its one-tangent result, bitwise
    (chip_smoke.plain_tracking serves several kernels with one plain
    pass on that ground), RK4 and RKF45; and the tracking pass's first 15
    planes and their tangents are the non-tracking pass's."""
    for integrator in ("rk4", "rkf45"):
        scene, _, o, d = soft_case(integrator, max_steps=60)
        tscene = scene_from_reference(scene, device="cpu")
        scene_fn = torch_scene_fn(tscene)
        tangents = [torch.func.jvp(
            lambda v: scene_fn(dict(zip(P0, v))),
            (list(torch_params().values()),),
            ([torch.tensor(float(k == name)) for k in P0],))[1]
            for name in P0]
        (scal, dscals, inp, dinps), _ = trace_kernel.prepare_fwdgrad(
            torch.from_numpy(o), torch.from_numpy(d), tscene, tangents)
        args = trace_kernel.planes_args(tscene)
        out2, dout2 = trace_kernel.trace_planes_fwdgrad_plain(
            scal, dscals, inp, dinps, *args)
        out1, dout1 = trace_kernel.trace_planes_fwdgrad_plain(
            scal, dscals[:1], inp, dinps[:1], *args)
        k1 = trace_kernel.trace_planes_plain(scal, inp, *args)
        hard = trace_kernel.trace_planes_fwdgrad_plain(
            scal, dscals, inp, dinps, *args[:3], False)
        for a, b in ((out1, out2), (dout1[0], dout2[0]), (k1, out2),
                     (hard[0], out2[:15]), (hard[1], dout2[:, :15])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_version_takes_per_ray_scalars():
    """The plain version of K2 takes the scene scalars elementwise, so
    rays of two scenes (spin 0 and 0.9) in one pass with per-ray scalars
    give each scene's own pass, bitwise (chip_smoke.plain_tracking runs
    the parity cases of an integrator in one plain pass on that
    ground)."""
    parts, refs = [], []
    for spin in (0.0, 0.9):
        scene, _, o, d = soft_case("rk4", max_steps=60)
        scene = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, spin=np.float32(spin)))
        tscene = scene_from_reference(scene, device="cpu")
        scene_fn = torch_scene_fn(tscene)
        p = {"mass": torch.tensor(1.0), "spin": torch.tensor(spin)}
        tangents = [torch.func.jvp(
            lambda v: scene_fn(dict(zip(P0, v))), (list(p.values()),),
            ([torch.tensor(float(k == name)) for k in P0],))[1]
            for name in P0]
        planes_in, _ = trace_kernel.prepare_fwdgrad(
            torch.from_numpy(o[:32]), torch.from_numpy(d[:32]), tscene,
            tangents)
        args = trace_kernel.planes_args(tscene)
        refs.append(trace_kernel.trace_planes_fwdgrad_plain(*planes_in,
                                                            *args))
        scal, dscals, inp, dinps = planes_in
        parts.append((scal[:, None].expand(-1, 32),
                      dscals[:, :, None].expand(-1, -1, 32), inp, dinps))
    batched = trace_kernel.trace_planes_fwdgrad_plain(
        *(torch.cat(x, dim=-1) for x in zip(*parts)), *args)
    for k, (out, douts) in enumerate(refs):
        cols = slice(32 * k, 32 * (k + 1))
        np.testing.assert_array_equal(batched[0][:, cols].numpy(),
                                      out.numpy())
        np.testing.assert_array_equal(batched[1][:, :, cols].numpy(),
                                      douts.numpy())
