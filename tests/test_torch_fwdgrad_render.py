"""render_value_and_grad of the PyTorch port against the JAX package.

The rays depend on a parameter: the camera's position y (with the mass),
so ray tangents ride beside the scene tangents through one pass of the
multi-tangent kernel (on CPU tensors its plain version).  8x8 rays of the
parity camera at y = -30, 48 steps, Kerr a = 0.9, disk on, under the
reference's contract: loss rtol 1e-5, gradients rtol 1e-3, atol 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blackhole_tpu.grad import fast_grad as jfast_grad
from blackhole_tpu.render import camera as jcam
from blackhole_tpu_torch.geom.types import (
    camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import camera as cam

from test_torch_fwdgrad_slice import jax_loss, parity_case, torch_loss

torch.set_num_threads(1)  # see tests/test_torch_step.py

P0 = {"mass": 1.0, "cam_y": -30.0}


def test_render_value_and_grad_matches_jax():
    scene, camera, _, _ = parity_case()

    def jsetup(p):
        c = dataclasses.replace(
            camera, position=camera.position.at[1].set(p["cam_y"]))
        o, d = jcam.generate_rays(c, 8, 8)
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"]))
        return s, o.reshape(-1, 3), d.reshape(-1, 3)

    vg = jfast_grad.render_value_and_grad(jax_loss, jsetup, interpret=True)
    v2, g2 = jax.jit(vg)({k: jnp.float32(v) for k, v in P0.items()})

    tscene = scene_from_reference(scene, device="cpu")
    tcamera = camera_from_reference(camera, device="cpu")

    def setup(p):
        pos = tcamera.position
        c = dataclasses.replace(
            tcamera, position=torch.stack([pos[0], p["cam_y"], pos[2]]))
        o, d = cam.generate_rays(c, 8, 8)
        s = dataclasses.replace(tscene, blackhole=dataclasses.replace(
            tscene.blackhole, mass=p["mass"]))
        return s, o.reshape(-1, 3), d.reshape(-1, 3)

    v1, g1 = fast_grad.render_value_and_grad(torch_loss, setup)(
        {k: torch.tensor(v) for k, v in P0.items()})
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    for k in P0:
        np.testing.assert_allclose(float(g1[k]), float(g2[k]), rtol=1e-3,
                                   atol=1e-8, err_msg=k)
    # The camera's gradient is not zero: the ray tangents did ride.
    assert float(g1["cam_y"]) != 0.0
