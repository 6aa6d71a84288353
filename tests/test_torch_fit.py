"""Bucketed gradients and the reverse-mode fit of the PyTorch port.

grad.bucketed.grad_over_chunks, grad.inverse.image_loss and one
make_train_step step against the JAX package's, float64 on the same
scene, camera and parameters (params_from_reference of the JAX
pack_params).  Gradients within rtol 1e-6 of jax.grad.  Adam:
optax.adam and torch.optim.Adam compute the same update with other
roundings, so the parameters after a step agree within rtol 1e-12; a
frozen parameter (mask 0) keeps its value bit for bit.  The JAX
package's gradients, target image and step are recorded once
(tests/jax_refs.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.grad import bucketed as jbucketed
from blackhole_tpu.grad import inverse as jinverse
from blackhole_tpu.render import camera as jcam
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, params_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import bucketed, diff_trace, inverse
from blackhole_tpu_torch.render import camera as cam

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py

F64 = torch.float64


def small_case(spin=0.5, max_steps=48):
    scene = jtypes.Scene(
        blackhole=jtypes.BlackHole.create(1.0, spin, dtype=jnp.float64),
        disk=jtypes.Disk.create(6.0, 20.0, dtype=jnp.float64),
        config=jtypes.SimConfig.create(
            time_step=0.5, max_ray_distance=80.0, max_steps=max_steps,
            dtype=jnp.float64),
        disk_enabled=True,
    )
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0,
                                  dtype=jnp.float64)
    return (scene, camera, scene_from_reference(scene, "cpu", F64),
            camera_from_reference(camera, "cpu", F64))


def test_bucket_ladder_matches_jax():
    for n in (64, 100, 1000, 2048):
        assert bucketed._buckets_for(n) == jbucketed._buckets_for(n)


def test_grad_over_chunks_matches_jax():
    """16x16 rays in 4 chunks, spin 0.9, 64 steps (one bucket), the loss
    sum(colour) per chunk: the total loss and d/d(mass, spin) against the
    JAX package's grad_over_chunks, and the sizing pass's per-chunk steps
    against the rays' own."""
    jscene, jcamera, scene, camera = small_case(spin=0.9, max_steps=64)
    o, d = jcam.generate_rays(jcamera, 16, 16)
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)

    def scene_fn(p):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"], spin=p["spin"]))

    want_loss, want = jax_refs.value_and_grad(
        jax_refs.load("fit_grad_over_chunks"))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    cache = {}
    loss, grads = bucketed.grad_over_chunks(
        scene_fn, {"mass": torch.tensor(1.0, dtype=F64),
                   "spin": torch.tensor(0.9, dtype=F64)},
        ot, dt, lambda c, i: torch.sum(c), chunks=4, cache=cache)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-9)
    for k in ("mass", "spin"):
        assert float(want[k]) != 0.0
        np.testing.assert_allclose(float(grads[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    assert cache == {}
    need = bucketed._chunk_steps(ot.view(4, -1, 3), dt.view(4, -1, 3), scene)
    hit = diff_trace.trace_rays_diff(ot, dt, scene)
    np.testing.assert_array_equal(need.numpy(),
                                  hit.steps.view(4, -1).amax(1).numpy())


def test_image_loss_and_train_step_match_jax():
    """image_loss's value and gradient (every parameter) against
    jax.value_and_grad, then one Adam step of make_train_step with the
    freeze mask of fit(optimize=("log_mass",)) against the JAX package's
    (optax.inject_hyperparams(adam), rate 2e-2), 8x8, 48 steps."""
    jscene, jcamera, scene, camera = small_case()
    bad = dataclasses.replace(
        jscene, blackhole=jtypes.BlackHole.create(1.15, 0.5,
                                                  dtype=jnp.float64))
    jparams = jinverse.pack_params(bad, jcamera)
    rec = jax_refs.load("fit_image_loss_and_train_step")
    target = rec["target"]
    want_loss, want_grads = jax_refs.value_and_grad(rec)
    assert set(want_grads) == set(jparams)

    def port_params():
        return {k: v.requires_grad_(True) for k, v in params_from_reference(
            {k: np.asarray(v) for k, v in jparams.items()}, "cpu",
            F64).items()}

    target_t = torch.from_numpy(np.asarray(target))
    params = port_params()
    loss = inverse.image_loss(params, target_t, scene, camera, 8, 8)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-9)
    for (k, v), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]),
                                   rtol=1e-6, atol=1e-14, err_msg=k)

    mask = {k: float(k == "log_mass") for k in jparams}
    jnew = {k: rec[f"new.{k}"] for k in jparams}
    jloss = rec["step_loss"]
    params = port_params()
    before = {k: v.detach().clone() for k, v in params.items()}
    adam, step = inverse._fit_step(8, 8)
    optimizer = adam(params, 2e-2)
    assert optimizer.param_groups[0]["lr"] == 2e-2
    params, optimizer, loss = step(params, optimizer, target_t, scene,
                                   camera, mask)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-9)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jnew[k]),
                                   rtol=1e-12, err_msg=k)
        if not mask[k]:
            assert torch.equal(v.detach(), before[k]), k
    assert float(params["log_mass"]) < float(before["log_mass"])


def test_fit_descends_and_keeps_frozen_parameters():
    """fit: three Adam steps on log_mass from mass 1.15 toward a target
    rendered at 1.0 lower the loss, and spin and every other frozen
    parameter stay bit for bit (no JAX: the port alone)."""
    _, _, scene, camera = small_case()
    target = diff_trace.render_image_diff(scene, camera, 8, 8)
    bad = dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=torch.tensor(1.15, dtype=F64)))
    seen = []
    fitted, fcam, losses = inverse.fit(
        target, bad, camera, 8, 8, steps=3, learning_rate=2e-2,
        optimize=("log_mass",),
        callback=lambda i, p, loss: seen.append(float(p["log_mass"])))
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert seen[0] < np.log(1.15) and seen == sorted(seen, reverse=True)
    assert abs(float(fitted.blackhole.mass) - 1.0) < 0.15
    start = inverse.unpack_params(inverse.pack_params(bad, camera), bad,
                                  camera)
    for a, b in ((fitted.blackhole.spin, start[0].blackhole.spin),
                 (fitted.disk.inner_radius, start[0].disk.inner_radius),
                 (fcam.position, start[1].position),
                 (fcam.fov_deg, start[1].fov_deg)):
        assert torch.equal(a, b)
    o, _ = cam.generate_rays(fcam, 2, 2)
    assert o.dtype == F64
