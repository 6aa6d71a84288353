"""fit_forward of the PyTorch port against the JAX package.

* pack_params / unpack_params against the JAX functions on a converted
  scene and camera (scene_from_reference, camera_from_reference), and
  the round trip through them.
* fit_forward for 3 Adam steps at 16x16 with the soft boundary
  (shadow_softness 0.3, disk on: every step is one pass of K2 with
  tracking; on CPU tensors its plain version), optimising log_mass and
  spin_raw from mass 1.03 against a target rendered at mass 1.0 at
  learning rate 1e-2, against the JAX fit_forward in interpret mode (its
  target image and losses recorded once: tests/jax_refs.py, case
  soft_fit).  Tolerance: each step's loss within rtol 1e-4.  The first
  loss is a forward render (rtol 1e-5
  between the two packages at this size); each later one follows an
  Adam step, whose first move is lr times the gradient's sign and whose
  next ones depend on the gradients' ratios, held by the gradient
  contract (rtol 1e-3), so the parameters and losses move together.
"""

import numpy as np
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.grad import inverse as jinverse
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import inverse

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py

SIZE = 16
# Adam's first move is lr times the gradient's sign: at optax's 3e-2 it
# takes log_mass from log(1.03) = 0.0296 to within 4e-4 of the target's,
# where the loss (quadratic in the error) keeps few significant digits.
LR = 1e-2


def _case(mass=1.0):
    scene = jtypes.Scene(
        jtypes.BlackHole.create(mass, 0.9, 0.1),
        jtypes.Disk.create(6.0, 20.0),
        jtypes.SimConfig.create(time_step=0.2, max_ray_distance=80.0,
                                max_steps=150, shadow_softness=0.3),
        disk_enabled=True,
    )
    camera = jtypes.Camera.create(position=(0.0, -35.0, 12.0),
                                  direction=(0.0, 35.0, -12.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=22.0)
    return scene, camera


def test_pack_unpack_match_jax():
    scene, camera = _case(1.03)
    ref = jinverse.pack_params(scene, camera)
    tscene = scene_from_reference(scene, device="cpu")
    tcamera = camera_from_reference(camera, device="cpu")
    got = inverse.pack_params(tscene, tcamera)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    s_ref, c_ref = jinverse.unpack_params(ref, scene, camera)
    s_got, c_got = inverse.unpack_params(got, tscene, tcamera)
    for name in ("mass", "spin", "charge"):
        g = getattr(s_got.blackhole, name)
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(getattr(s_ref.blackhole, name)),
                                   rtol=1e-6, err_msg=name)
        # The round trip returns the scene's own values.
        np.testing.assert_allclose(g.numpy(),
                                   getattr(tscene.blackhole, name).numpy(),
                                   rtol=1e-5, err_msg=name)
    for name in ("inner_radius", "outer_radius", "temperature_scale"):
        np.testing.assert_allclose(getattr(s_got.disk, name).numpy(),
                                   np.asarray(getattr(s_ref.disk, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(c_got.fov_deg.numpy(),
                               np.asarray(c_ref.fov_deg), rtol=1e-6)
    np.testing.assert_array_equal(c_got.position.numpy(),
                                  np.asarray(c_ref.position))
    assert inverse.MAX_SPIN == jinverse.MAX_SPIN


def test_fit_forward_matches_jax():
    _, camera = _case(1.0)
    rec = jax_refs.load("soft_fit")
    target, ref = rec["target"], rec["losses"]
    init_scene, _ = _case(1.03)
    seen = []
    scene, _, got = inverse.fit_forward(
        torch.from_numpy(target), scene_from_reference(init_scene, device="cpu"),
        camera_from_reference(camera, device="cpu"), SIZE, SIZE, steps=3,
        learning_rate=LR, callback=lambda i, p, loss: seen.append(sorted(p)))
    assert len(got) == len(ref) == 3 and len(seen) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # The fit moves the mass toward the target's and lowers the loss.
    assert got[2] < got[0]
    assert abs(float(torch.log(scene.blackhole.mass))) < np.log(1.03)
