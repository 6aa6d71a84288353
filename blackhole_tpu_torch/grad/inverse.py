"""Inverse rendering: fit scene parameters to a target image.

PyTorch counterpart of blackhole_tpu.grad.inverse: the unconstrained
parameterisation (pack_params, unpack_params: log for positive
quantities, a scaled tanh for spin, so an optimiser step never leaves
the physical manifold); fit_forward, each of whose steps is ONE pass of
the multi-tangent kernel K2 (grad.fast_grad.render_value_and_grad); and
fit, by reverse mode through the checkpointed trace (image_loss,
make_train_step).  Adam is torch.optim.Adam at optax.adam's defaults
(betas 0.9 and 0.999, eps 1e-8), host code.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.grad import diff_trace, fast_grad
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.tangent_rules import jmax

MAX_SPIN = 0.998  # Thorne limit; keeps Delta bounded away from 0.


def _charge_budget(spin):
    """Max Q/M compatible with sub-extremality at this spin:
    spin^2 + (Q/M)^2 <= MAX_SPIN^2."""
    return torch.sqrt(jmax(MAX_SPIN**2 - spin * spin, 1e-12))


def pack_params(scene: Scene, camera: Camera) -> dict:
    """Scene and camera -> the unconstrained parameter dict."""
    bh, disk = scene.blackhole, scene.disk
    spin = torch.clamp(bh.spin, 0.0, 0.999 * MAX_SPIN)
    q_frac = bh.charge / torch.clamp(bh.mass, min=1e-12)
    return {
        "log_mass": torch.log(bh.mass),
        "spin_raw": torch.atanh(torch.clamp(bh.spin / MAX_SPIN, 0.0, 0.999)),
        # Q = M budget(spin) tanh(charge_raw): sub-extremal while spin
        # moves; the metric depends on Q^2 only, so |Q| is the observable.
        "charge_raw": torch.atanh(
            torch.clamp(q_frac / _charge_budget(spin), 0.0, 0.999)
        ),
        "log_disk_inner": torch.log(disk.inner_radius),
        "log_disk_width": torch.log(disk.outer_radius - disk.inner_radius),
        "log_temp_scale": torch.log(disk.temperature_scale),
        "cam_position": camera.position,
        "log_fov": torch.log(camera.fov_deg),
    }


def unpack_params(params: dict, template_scene: Scene,
                  template_camera: Camera) -> tuple[Scene, Camera]:
    """Unconstrained parameters -> (Scene, Camera); every other field
    from the templates."""
    mass = torch.exp(params["log_mass"])
    spin = MAX_SPIN * torch.tanh(params["spin_raw"])
    charge = mass * _charge_budget(spin) * torch.tanh(
        params.get("charge_raw", torch.zeros_like(spin))
    )
    inner = torch.exp(params["log_disk_inner"])
    outer = inner + torch.exp(params["log_disk_width"])
    bh = dataclasses.replace(
        template_scene.blackhole, mass=mass, spin=spin, charge=charge
    )
    disk = dataclasses.replace(
        template_scene.disk,
        inner_radius=inner,
        outer_radius=outer,
        temperature_scale=torch.exp(params["log_temp_scale"]),
    )
    scene = dataclasses.replace(template_scene, blackhole=bh, disk=disk)
    camera = dataclasses.replace(
        template_camera,
        position=params["cam_position"],
        fov_deg=torch.exp(params["log_fov"]),
    )
    return scene, camera


def fit_forward(target, init_scene: Scene, init_camera: Camera, width: int,
                height: int, steps: int = 100, learning_rate: float = 3e-2,
                optimize: tuple = ("log_mass", "spin_raw"), callback=None):
    """Fit the parameters named in `optimize` to `target` (H, W, 3) by
    Adam on 0.5 mean squared pixel error, one K2 pass per step
    (render_value_and_grad: the rays are generated inside the
    differentiated function, so camera parameters work too); the others
    stay frozen.  Returns (scene, camera, losses), losses[i] being the
    loss before step i.

    Adam is torch.optim.Adam with optax.adam's defaults (betas 0.9 and
    0.999, eps 1e-8), host code.  For fits at image scale set
    shadow_softness > 0 on init_scene.config and render the target with
    the same config: hard-edge gradients miss the shadow and disk
    boundaries sweeping across pixels (the JAX package measured a
    wrong-signed d/d(mass) at 256^2)."""
    params_all = pack_params(init_scene, init_camera)
    opt_params = {k: params_all[k].detach().clone() for k in optimize}
    frozen = {k: v for k, v in params_all.items() if k not in optimize}

    def setup_fn(p):
        scene, camera = unpack_params({**frozen, **p}, init_scene,
                                      init_camera)
        origins, dirs = cam.generate_rays(camera, width, height)
        return scene, origins.reshape(-1, 3), dirs.reshape(-1, 3)

    target = torch.as_tensor(target, dtype=torch.float32,
                             device=init_camera.position.device)

    def loss_of_hit(hit):
        img = hit.color.reshape(target.shape)
        return 0.5 * torch.mean((img - target) ** 2)

    vg = fast_grad.render_value_and_grad(loss_of_hit, setup_fn)
    optimizer = torch.optim.Adam(list(opt_params.values()), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for i in range(steps):
        loss, grads = vg(opt_params)
        for k, p in opt_params.items():
            p.grad = grads[k].to(p.dtype).reshape(p.shape)
        optimizer.step()
        losses.append(float(loss))
        if callback is not None:
            callback(i, {**frozen, **opt_params}, loss)
    scene, camera = unpack_params({**frozen, **opt_params}, init_scene,
                                  init_camera)
    return scene, camera, losses


def image_loss(params: dict, target, template_scene: Scene,
               template_camera: Camera, width: int, height: int):
    """0.5 * mean squared pixel error of the differentiable render."""
    scene, camera = unpack_params(params, template_scene, template_camera)
    img = diff_trace.render_image_diff(scene, camera, width, height)
    return 0.5 * torch.mean((img - target) ** 2)


def make_train_step(width: int, height: int):
    """step(params, optimizer, target, template_scene, template_camera,
    mask=None) -> (params, optimizer, loss): one optimiser step in
    place.  params' tensors are the optimizer's parameters (leaves that
    require grad); the optimizer holds its state and its learning rate
    (param_groups), as optax's inject_hyperparams state does.  mask:
    optional dict of 0/1 multipliers of the gradients, the freeze
    mechanism of fit (a frozen parameter's Adam moments stay 0, so its
    value stays bit for bit)."""

    def step(params, optimizer, target, template_scene, template_camera,
             mask=None):
        names = list(params)
        loss = image_loss(params, target, template_scene, template_camera,
                          width, height)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        for k, g in zip(names, grads):
            g = torch.zeros_like(params[k]) if g is None else g
            params[k].grad = g * mask[k] if mask is not None else g
        optimizer.step()
        return params, optimizer, loss.detach()

    return step


def _adam(params: dict, learning_rate: float):
    """torch.optim.Adam over params' tensors at optax.adam's defaults."""
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


@functools.lru_cache(maxsize=None)
def _fit_step(width: int, height: int):
    """(optimizer factory, train step) for fit at these image sizes."""
    return _adam, make_train_step(width, height)


def fit(target, init_scene: Scene, init_camera: Camera, width: int,
        height: int, steps: int = 100, learning_rate: float = 3e-2,
        optimize: tuple = ("log_mass", "spin_raw"), callback=None):
    """Fit the parameters named in `optimize` to `target` (H, W, 3) by
    Adam on image_loss, reverse mode through the checkpointed trace
    (grad.diff_trace); every other parameter gets a zero gradient mask
    and stays as it was.  Returns (scene, camera, losses), losses[i]
    being the loss before step i.  For few-parameter fits on a GPU,
    fit_forward (one K2 pass per step) is the faster engine."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pack_params(init_scene, init_camera).items()}
    mask = {k: float(k in optimize) for k in params}
    adam, step_fn = _fit_step(width, height)
    optimizer = adam(params, learning_rate)
    target = torch.as_tensor(target, dtype=params["log_mass"].dtype,
                             device=params["log_mass"].device)
    losses = []
    for i in range(steps):
        params, optimizer, loss = step_fn(params, optimizer, target,
                                          init_scene, init_camera, mask)
        losses.append(float(loss))
        if callback is not None:
            callback(i, params, loss)
    scene, camera = unpack_params({k: v.detach() for k, v in params.items()},
                                  init_scene, init_camera)
    return scene, camera, losses
