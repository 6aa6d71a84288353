"""The soft boundary's gradient physics through the PyTorch port alone.

The JAX package's acceptance bar for the full soft stack
(tests/test_grad.py, test_crossing_opacity_mse_gradient_matches_fd):
at 48x48, 300 steps, softness 0.3 (survival sigmoid of the capture
margin, annulus window, crossing opacity, TANGENT_CLIP), the pathwise
d(MSE)/d(mass) from torch.func.jvp through image.trace_rays_fast (the
planes pass's forward-mode rule: K2-track with one tangent; on CPU
tensors its plain version) tracks central finite differences of the
loss (eps 3e-3) within rtol 0.2 and with the same sign, on both sides of
the optimum (m0 = 1.03 and 0.98).  No JAX runs here: the port is held
to the physics, not to the other package.
"""

import dataclasses

import numpy as np
import torch

from blackhole_tpu_torch.geom.types import (
    BlackHole, Camera, Disk, Scene, SimConfig,
)
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image

torch.set_num_threads(1)  # see tests/test_torch_step.py

CPU = dict(device="cpu")


def test_soft_mse_gradient_matches_fd():
    camera = Camera.create(position=(0.0, -35.0, 12.0),
                           direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                           fov_deg=22.0, **CPU)
    o, d = cam.generate_rays(camera, 48, 48)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    base = Scene(BlackHole.create(1.0, 0.9, **CPU),
                 Disk.create(6.0, 20.0, **CPU),
                 SimConfig.create(time_step=0.1, max_ray_distance=150.0,
                                  max_steps=300, shadow_softness=0.3, **CPU),
                 disk_enabled=True)

    def render(mass):
        s = dataclasses.replace(base, blackhole=dataclasses.replace(
            base.blackhole, mass=mass))
        return fast_grad.clip_color_tangent(
            image.trace_rays_fast(o, d, s)).color

    target = render(torch.tensor(1.0))

    def loss(mass):
        return 0.5 * torch.mean((render(mass) - target) ** 2)

    for m0, eps in ((1.03, 3e-3), (0.98, 3e-3)):
        _, dv = torch.func.jvp(loss, (torch.tensor(m0),),
                               (torch.tensor(1.0),))
        fd = (float(loss(torch.tensor(m0 + eps)))
              - float(loss(torch.tensor(m0 - eps)))) / (2 * eps)
        assert np.sign(float(dv)) == np.sign(fd), (float(dv), fd)
        np.testing.assert_allclose(float(dv), fd, rtol=0.2)
