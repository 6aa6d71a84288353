"""Forward-mode gradients of the soft boundary in the PyTorch port against
the JAX package, RK4.

The case of test_torch_fwdgrad_slice.py (the first 64 rays of the 32x32
parity camera, 48 steps, Kerr a = 0.9, disk on, params {mass, spin})
with shadow_softness 0.3: the planes pass is K2's tracking variant (on
CPU tensors its plain version) and the Hit tangent carries the capture
margin's tangent.  grad.fast_grad.scene_value_and_grad against the JAX
package's, jitted in interpret mode, under the reference's contract
(loss rtol 1e-5, gradients rtol 1e-3, atol 1e-8), and each ray's colour
tangent against trace_rays_pallas_fwdgrad's (test_torch_fwdgrad_slice's
bound).  A further case with a ray tangent (the camera moving) runs the
margin's tangent along the rays.  The RKF45 case is in
test_torch_soft_rkf45.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from blackhole_tpu.grad import fast_grad as jfast_grad
from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.geom.types import scene_from_reference
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import trace_kernel

from test_torch_fwdgrad_slice import (
    P0, assert_grad_contract, jax_loss, jax_params, jax_scene_fn,
    parity_case, torch_loss, torch_params, torch_scene_fn,
)

torch.set_num_threads(1)  # see tests/test_torch_step.py


def soft_case(integrator="rk4", max_steps=48, softness=0.3):
    scene, camera, o, d = parity_case(integrator, max_steps)
    scene = dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, shadow_softness=softness))
    return scene, camera, o, d


def test_soft_scene_value_and_grad_matches_jax():
    scene, _, o, d = soft_case()
    scene_fn = jax_scene_fn(scene)
    vg = jfast_grad.scene_value_and_grad(jax_loss, scene_fn, interpret=True)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    def run(p):
        tangents = [jax.jvp(scene_fn, (p,), ({k: jnp.float32(k == name)
                                              for k in P0},))[1]
                    for name in P0]
        hit, dhits = pallas_kernel.trace_rays_pallas_fwdgrad(
            jo, jd, scene_fn(p), tangents, interpret=True)
        # A ray tangent: the camera moving along x.
        _, ray_dhits = pallas_kernel.trace_rays_pallas_fwdgrad(
            jo, jd, scene_fn(p), [(jax.tree_util.tree_map(
                jnp.zeros_like, scene_fn(p)),
                jnp.broadcast_to(jnp.float32([1.0, 0.0, 0.0]), jo.shape),
                jnp.zeros_like(jd))], interpret=True)
        return (vg(p, jo, jd), hit.result,
                [dh.color for dh in dhits] + [ray_dhits[0].color])

    ref, res_ref, dcol_ref = jax.jit(run)(jax_params())

    tscene = scene_from_reference(scene, device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    before = trace_kernel.fwdgrad_launches
    got = fast_grad.scene_value_and_grad(torch_loss, torch_scene_fn(tscene))(
        torch_params(), to, td)
    assert trace_kernel.fwdgrad_launches == before  # CPU: the plain version
    assert_grad_contract(got, ref)

    tscene_fn = torch_scene_fn(tscene)
    p = torch_params()
    tangents = [torch.func.jvp(
        lambda v: tscene_fn(dict(zip(P0, v))), (list(p.values()),),
        ([torch.tensor(float(k == name)) for k in P0],))[1] for name in P0]
    tangents.append((pytree.tree_map(torch.zeros_like, tscene),
                     torch.tensor([1.0, 0.0, 0.0]).expand(64, 3),
                     torch.zeros(64, 3)))
    hit, dhits = trace_kernel.trace_rays_kernel_fwdgrad(to, td, tscene,
                                                        tangents)
    agree = hit.result.numpy() == np.asarray(res_ref)
    assert agree.mean() > 0.95
    for dh, dr in zip(dhits, dcol_ref):
        g, r = dh.color.numpy()[agree], np.asarray(dr)[agree]
        bound = 1e-2 * (np.abs(r) + np.abs(r).max())
        assert np.all(np.abs(g - r) <= bound)
        assert np.abs(r).max() > 0
