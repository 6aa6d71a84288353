"""Deployment export: the renderer as a serialized torch.export program.

PyTorch counterpart of blackhole_tpu.export.  The JAX package lowers
its tracer to versioned StableHLO bytes (jax.export); here torch.export
captures what image.trace_rays_fast (engine "auto") runs, as an
ExportedProgram saved to bytes with torch.export.save:
- RK4 and RKF45 scenes: the geodesic-kernel path
  (render.trace_kernel.trace_rays_kernel: prepare, the planes pass,
  postprocess).  The planes pass is recorded as the registered operator
  blackhole_tpu_torch::trace_planes: the program launches K1
  (csrc/trace_kernel.cu) when it is called on CUDA tensors and runs K1's
  plain version on CPU tensors.
- LEAPFROG and YOSHIDA scenes: the XLA engine (render.trace.trace_rays),
  whose step loop is recorded as a traced while_loop, as the JAX
  package's is; the program runs on the device of its inputs.

Artifacts are resolution- and config-specialized: the integrator, the
step budget, disk on/off and the soft boundary are baked in; use
poly_batch=True for a symbolic ray count (torch.export.Dim).  Scene
parameters stay RUNTIME inputs: the 11 scene scalars (_scene_args
order) and, for export_render, the camera are arguments of the program,
so one artifact serves every parameter setting.

One difference from the JAX package's artifacts: loading one needs this
package imported (import blackhole_tpu_torch), which registers the
operators the program calls (init_null_rays, and trace_planes for RK4
and RKF45): the artifact does not run without this package's Python
source.
"""

from __future__ import annotations

import dataclasses
import io
import weakref

import torch
from torch.utils import _pytree as pytree

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.render import camera as cam_mod
from blackhole_tpu_torch.render import image


def _scene_args(scene: Scene):
    """The runtime-tunable leaves of a Scene as a flat tuple; static
    config stays baked into the artifact."""
    bh, disk, cfg = scene.blackhole, scene.disk, scene.config
    return (
        bh.mass, bh.spin, bh.charge,
        disk.inner_radius, disk.outer_radius,
        disk.temperature_scale, disk.density_scale,
        disk.inclination,
        cfg.time_step, cfg.max_ray_distance, cfg.tolerance,
    )


def _rebuild_scene(template: Scene, args) -> Scene:
    (mass, spin, charge, r_in, r_out, t_scale, d_scale, incl,
     dt, max_dist, tol) = args
    return dataclasses.replace(
        template,
        blackhole=dataclasses.replace(
            template.blackhole, mass=mass, spin=spin, charge=charge
        ),
        disk=dataclasses.replace(
            template.disk, inner_radius=r_in, outer_radius=r_out,
            temperature_scale=t_scale, density_scale=d_scale,
            inclination=incl,
        ),
        config=dataclasses.replace(
            template.config, time_step=dt, max_ray_distance=max_dist,
            tolerance=tol,
        ),
    )


class _Trace(torch.nn.Module):
    def __init__(self, template: Scene):
        super().__init__()
        self.template = template

    def forward(self, *args):
        scene = _rebuild_scene(self.template, args[:-2])
        return image.trace_rays_fast(args[-2], args[-1], scene).color


class _Render(torch.nn.Module):
    def __init__(self, template: Scene, camera: Camera, width: int,
                 height: int):
        super().__init__()
        self.template, self.camera = template, camera
        self.width, self.height = width, height

    def forward(self, *args):
        scene = _rebuild_scene(self.template, args[:-4])
        pos, dirn, up, fov = args[-4:]
        camera = dataclasses.replace(self.camera, position=pos,
                                     direction=dirn, up=up, fov_deg=fov)
        o, d = cam_mod.generate_rays(camera, self.width, self.height)
        hit = image.trace_rays_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                    scene)
        return hit.color.reshape(self.height, self.width, 3)


def _on(record, device):
    """A Scene or Camera with every tensor on device (the template's
    tensors are constants of the program)."""
    return pytree.tree_map(lambda t: t.to(device), record)


def _scalars(scene: Scene, device):
    return tuple(a.detach().to(device=device, dtype=torch.float32).clone()
                 for a in _scene_args(scene))


def _save(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_trace(scene: Scene, n_rays: int | None = None,
                 poly_batch: bool = False, device=None) -> bytes:
    """Export the batched ray tracer as a serialized ExportedProgram.

    The program has signature
        (scene_args..., origins (N, 3), directions (N, 3)) -> color (N, 3)
    with scene_args the 11 runtime scene scalars (_scene_args order),
    all float32.  poly_batch=True exports with a symbolic N (any ray
    count of at least 2 at call time); otherwise n_rays is required and
    baked in.  device: where the program runs (default: the scene's);
    a CUDA program of an RK4 or RKF45 scene launches K1."""
    if not poly_batch and n_rays is None:
        raise ValueError("n_rays required unless poly_batch=True")
    device = torch.device(device or scene.blackhole.mass.device)
    rays = torch.zeros((16 if poly_batch else n_rays, 3), device=device)
    args = _scalars(scene, device) + (rays, rays.clone())
    dynamic = None
    if poly_batch:
        batch = torch.export.Dim("n", min=2)
        dynamic = ((None,) * (len(args) - 2) + ({0: batch}, {0: batch}),)
    program = torch.export.export(_Trace(_on(scene, device)), args,
                                  dynamic_shapes=dynamic)
    return _save(program)


def export_render(scene: Scene, camera: Camera, width: int, height: int,
                  device=None) -> bytes:
    """Export a full fixed-resolution render:
    (scene_args..., cam_pos (3,), cam_dir (3,), cam_up (3,), fov ())
    -> (H, W, 3) image, all float32."""
    device = torch.device(device or camera.position.device)
    cam_args = tuple(t.detach().to(device=device, dtype=torch.float32)
                     for t in (camera.position, camera.direction, camera.up,
                               camera.fov_deg))
    program = torch.export.export(
        _Render(_on(scene, device), _on(camera, device), width, height),
        _scalars(scene, device) + cam_args)
    return _save(program)


def load(blob: bytes):
    """Deserialize an exported artifact: an ExportedProgram, whose
    .module() is callable.  This package must be imported (it is, by
    this module) so that the program's operators are registered."""
    return torch.export.load(io.BytesIO(blob))


# Each program's callable module, built once: ExportedProgram.module()
# builds a new one on every call (~0.1 s).
_MODULES = weakref.WeakKeyDictionary()


def _module(exported):
    if exported not in _MODULES:
        _MODULES[exported] = exported.module()
    return _MODULES[exported]


def call_trace(exported, scene: Scene, origins, directions):
    """Convenience: invoke an export_trace artifact with a Scene."""
    args = _scalars(scene, origins.device)
    return _module(exported)(*args, origins.to(torch.float32),
                             directions.to(torch.float32))


def call_render(exported, scene: Scene, camera: Camera):
    """Convenience: invoke an export_render artifact."""
    device = camera.position.device
    return _module(exported)(
        *_scalars(scene, device),
        *(t.to(torch.float32) for t in (camera.position, camera.direction,
                                         camera.up, camera.fov_deg)))
