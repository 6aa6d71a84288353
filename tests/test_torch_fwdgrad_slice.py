"""The forward-mode gradient slice of the PyTorch port against the JAX package.

On CPU tensors the port's kernels are their plain versions, so these
tests hold the port's arithmetic and host code to the JAX package's
(the CUDA kernels are held to the plain versions on the card:
tests/test_torch_gpu.py, chip_smoke.py).  The case is the JAX package's
own multi-tangent check (tests/test_pallas.py,
test_pallas_multi_tangent_value_and_grad): the first 64 rays of the 32x32
parity camera, 48 steps, Kerr a = 0.9, disk on, params {mass, spin}.

* grad.fast_grad.scene_value_and_grad against the JAX package's, jitted
  in interpret mode (recorded once: tests/jax_refs.py), under the reference's own contract: loss rtol 1e-5,
  both gradients rtol 1e-3, atol 1e-8; and each ray's colour tangent
  against trace_rays_pallas_fwdgrad's.
* The tangent of prepare (a torch.func.jvp of a function that itself
  calls torch.func.jvp) against jax.jvp of pallas_kernel._prepare.
* value_and_grad_fwd with clip_color_tangent (one jvp per parameter
  through the planes pass's forward-mode rule: K2 with one tangent, K3)
  equals scene_value_and_grad.
* A depth-sorted trace_rays_kernel_fwdgrad equals the raster one bitwise.
* Reverse mode through the kernel raises instead of returning zeros.
The RKF45 case and render_value_and_grad are in
test_torch_fwdgrad_rkf45.py and test_torch_fwdgrad_render.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.grad import fast_grad as jfast_grad
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace_kernel

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py


def parity_case(integrator="rk4", max_steps=48, n=64, time_step=0.1):
    """The JAX scene and camera and the first n rays of the 32x32 image."""
    scene = jtypes.Scene(
        jtypes.BlackHole.create(1.0, 0.9), jtypes.Disk.create(6.0, 20.0),
        jtypes.SimConfig.create(time_step=time_step, max_ray_distance=80.0,
                                max_steps=max_steps, integrator=integrator),
        disk_enabled=True,
    )
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0)
    o, d = jcam.generate_rays(camera, 32, 32)
    o = np.array(o, np.float32).reshape(-1, 3)[:n]
    d = np.array(d, np.float32).reshape(-1, 3)[:n]
    return scene, camera, o, d


def jax_scene_fn(scene):
    def scene_fn(p):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"], spin=p["spin"]))
    return scene_fn


def torch_scene_fn(tscene):
    def scene_fn(p):
        return dataclasses.replace(tscene, blackhole=dataclasses.replace(
            tscene.blackhole, mass=p["mass"], spin=p["spin"]))
    return scene_fn


def jax_loss(hit):
    return jnp.sum(hit.color) / hit.color.size


def torch_loss(hit):
    return hit.color.sum() / hit.color.numel()


P0 = {"mass": 1.0, "spin": 0.9}


def jax_params():
    return {k: jnp.float32(v) for k, v in P0.items()}


def torch_params():
    return {k: torch.tensor(v) for k, v in P0.items()}


def assert_grad_contract(got, ref):
    """The reference's own contract (tools/tpu_parity.py:147-148 and
    tests/test_pallas.py): loss rtol 1e-5, gradients rtol 1e-3, atol
    1e-8."""
    (v1, g1), (v2, g2) = got, ref
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    for k in P0:
        np.testing.assert_allclose(float(g1[k]), float(g2[k]), rtol=1e-3,
                                   atol=1e-8, err_msg=k)


def _jax_rk4(scene, o, d):
    """The JAX package's scene_value_and_grad and, in the same jitted
    program, trace_rays_pallas_fwdgrad's hit and colour tangents
    (recorded once: tests/jax_refs.py, case fwdgrad_slice_rk4)."""
    scene_fn = jax_scene_fn(scene)
    vg = jfast_grad.scene_value_and_grad(jax_loss, scene_fn, interpret=True)

    def run(p):
        tangents = [jax.jvp(scene_fn, (p,), ({k: jnp.float32(k == name)
                                              for k in P0},))[1]
                    for name in P0]
        hit, dhits = pallas_kernel.trace_rays_pallas_fwdgrad(
            o, d, scene_fn(p), tangents, interpret=True)
        return vg(p, o, d), hit.result, [dh.color for dh in dhits]

    return jax.jit(run)(jax_params())


@pytest.fixture(scope="module")
def rk4():
    scene, camera, o, d = parity_case()
    rec = jax_refs.load("fwdgrad_slice_rk4")
    ref = (jax_refs.value_and_grad(rec), rec["result"],
           [rec[f"dcolor.{i}"] for i in range(len(P0))])
    tscene = scene_from_reference(scene, device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = fast_grad.scene_value_and_grad(torch_loss, torch_scene_fn(tscene))(
        torch_params(), to, td)
    return dict(scene=scene, tscene=tscene, o=to, d=td, ref=ref, got=got)


def test_scene_value_and_grad_matches_jax(rk4):
    assert_grad_contract(rk4["got"], rk4["ref"][0])
    assert all(bool(torch.isfinite(g)) for g in rk4["got"][1].values())


def test_fwdgrad_colour_tangents_match_jax(rk4):
    """Each ray's colour tangent against trace_rays_pallas_fwdgrad's,
    on rays whose result codes agree.  These rays end at MAX_STEPS with
    the sky colour of their last chord's direction, whose tangent is a
    chord tangent over its length (the 1e-2 class of the step test,
    tests/test_torch_fwdgrad_step.py): held to |got - ref| <= 1e-2
    (|ref| + the largest |ref|), measured 2e-3."""
    tscene = rk4["tscene"]
    scene_fn = torch_scene_fn(tscene)
    p = torch_params()
    tangents = [torch.func.jvp(
        lambda v: scene_fn(dict(zip(P0, v))), (list(p.values()),),
        ([torch.tensor(float(k == name)) for k in P0],))[1] for name in P0]
    hit, dhits = trace_kernel.trace_rays_kernel_fwdgrad(rk4["o"], rk4["d"],
                                                        tscene, tangents)
    _, res_ref, dcol_ref = rk4["ref"]
    agree = hit.result.numpy() == np.asarray(res_ref)
    assert agree.mean() > 0.95
    for dh, dr in zip(dhits, dcol_ref):
        g, r = dh.color.numpy()[agree], np.asarray(dr)[agree]
        bound = 1e-2 * (np.abs(r) + np.abs(r).max())
        assert np.all(np.abs(g - r) <= bound)


def test_prepare_tangent_matches_jax(rk4):
    """The kernel's input tangents: torch.func.jvp of prepare (whose null
    initialisation calls torch.func.jvp itself) against jax.jvp of
    _prepare, per parameter.  The BL momenta come from a derivative of
    the coordinate map, so their tangents are second derivatives with a
    few ulp of each framework's rounding: rtol 1e-4 with an absolute
    floor of 1e-4 of each plane's scale."""
    scene, tscene = rk4["scene"], rk4["tscene"]
    o, d = rk4["o"].numpy(), rk4["d"].numpy()
    n = o.shape[0]
    for name in P0:
        def jpre(s):
            return pallas_kernel._prepare(jnp.asarray(o), jnp.asarray(d), s,
                                          8)

        jtan = jax.jvp(jax_scene_fn(scene), (jax_params(),),
                       ({k: jnp.float32(k == name) for k in P0},))[1]
        _, (jdscal, jdinp) = jax.jvp(jpre, (scene,), (jtan,))
        jdscal = np.asarray(jdscal)[:, 0, 0]
        jdinp = np.asarray(jdinp).transpose(1, 0, 2, 3).reshape(16, -1)[:, :n]
        scene_fn = torch_scene_fn(tscene)
        ttan = torch.func.jvp(
            lambda v: scene_fn(dict(zip(P0, v))),
            (list(torch_params().values()),),
            ([torch.tensor(float(k == name)) for k in P0],))[1]
        _, (dscal, dinp) = torch.func.jvp(
            lambda s: trace_kernel.prepare(rk4["o"], rk4["d"], s),
            (tscene,), (ttan,))
        # r_shell_min (slot 11) enters only comparisons; its tangent is
        # not used.
        np.testing.assert_allclose(dscal.numpy()[:11], jdscal[:11],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        for k in range(16):
            ref = jdinp[k]
            np.testing.assert_allclose(
                dinp.numpy()[k], ref, rtol=1e-4,
                atol=1e-4 * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{name} plane {k}")


def test_value_and_grad_fwd_equals_scene_value_and_grad(rk4):
    """One jvp per parameter through trace_rays_fast (the planes pass's
    forward-mode rule runs K2 with one tangent: K3) with the same clipped
    estimator gives the multi-tangent result: the arithmetic of each
    tangent direction is the same, so within 1e-6."""
    tscene = rk4["tscene"]
    o, d = rk4["o"], rk4["d"]
    scene_fn = torch_scene_fn(tscene)

    def loss(p):
        hit = image.trace_rays_fast(o, d, scene_fn(p))
        return torch_loss(fast_grad.clip_color_tangent(hit))

    before = trace_kernel.fwdgrad_launches
    v1, g1 = fast_grad.value_and_grad_fwd(loss)(torch_params())
    v2, g2 = rk4["got"]
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    for k in P0:
        np.testing.assert_allclose(float(g1[k]), float(g2[k]), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert trace_kernel.fwdgrad_launches == before


def test_depth_sorted_fwdgrad_equals_raster():
    """The wide step (0.5) makes the 8x8 rays retire after different step
    counts within 40 steps, so the depth order is not the identity."""
    scene, camera, _, _ = parity_case(max_steps=40, time_step=0.5)
    tscene = scene_from_reference(scene, device="cpu")
    tcamera = camera_from_reference(camera, device="cpu")
    o, d = cam.generate_rays(tcamera, 8, 8)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    order = image.predicted_depth_order(tscene, tcamera, 8, 8, block=1)
    assert sorted(order.tolist()) == list(range(64))
    assert not torch.equal(order, torch.arange(64))
    scene_fn = torch_scene_fn(tscene)
    # A scene tangent (d/dmass) and a ray tangent (the camera moving
    # along y).
    tangents = [
        torch.func.jvp(lambda v: scene_fn(dict(zip(P0, v))),
                       (list(torch_params().values()),),
                       ([torch.tensor(1.0), torch.tensor(0.0)],))[1],
        (pytree.tree_map(torch.zeros_like, tscene),
         torch.tensor([0.0, 1.0, 0.0]).expand(64, 3), torch.zeros(64, 3)),
    ]
    raster = trace_kernel.trace_rays_kernel_fwdgrad(o, d, tscene, tangents)
    ordered = trace_kernel.trace_rays_kernel_fwdgrad(o, d, tscene, tangents,
                                                     order=order)
    for h_r, h_s in zip([raster[0], *raster[1]], [ordered[0], *ordered[1]]):
        for f in dataclasses.fields(h_r):
            assert torch.equal(getattr(h_r, f.name), getattr(h_s, f.name)), \
                f.name


def test_reverse_mode_raises(rk4):
    """A mass that requires grad traces (forward), and .backward()
    through the kernel raises instead of returning a silent zero."""
    tscene = rk4["tscene"]
    mass = tscene.blackhole.mass.clone().requires_grad_(True)
    hit = trace_kernel.trace_rays_kernel(
        rk4["o"][:16], rk4["d"][:16], dataclasses.replace(
            tscene, blackhole=dataclasses.replace(tscene.blackhole,
                                                  mass=mass)))
    with pytest.raises(NotImplementedError):
        hit.color.sum().backward()
