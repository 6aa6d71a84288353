"""Entry points: the flagship forward render and a multi-rank dry
run.

PyTorch counterpart of the JAX package's __graft_entry__.py.

entry()              -- (fn, example_args): the forward render of the
                        flagship scene, Kerr a=0.9 with the disk, 64x64.
dryrun_multichip(n)  -- a world of n ranks (parallel.launch.run_world)
                        runs the sharded render on both engines, the
                        multi-tile depth-sorted leg and ONE distributed
                        training step (sharded reverse mode, all-reduced
                        gradients, replicated Adam update) on small
                        shapes.
"""

from __future__ import annotations

import math

import torch

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.grad import inverse
from blackhole_tpu_torch.parallel import launch
from blackhole_tpu_torch.parallel import mesh as pmesh
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image


def _flagship_scene_camera(device, dtype=torch.float32, max_steps=256,
                           max_ray_distance=80.0):
    scene = Scene(
        blackhole=BlackHole.create(1.0, 0.9, device=device, dtype=dtype),
        disk=Disk.create(6.0, 20.0, 1.0, 1.0, device=device, dtype=dtype),
        config=SimConfig.create(time_step=0.1,
                                max_ray_distance=max_ray_distance,
                                max_steps=max_steps, device=device,
                                dtype=dtype),
        disk_enabled=True,
    )
    camera = Camera.create(position=(0.0, -35.0, 12.0),
                           direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                           fov_deg=22.0, device=device, dtype=dtype)
    return scene, camera


def entry(device="cuda"):
    """(fn, example_args): fn(origins, dirs, scene) -> (64, 64, 3), the
    flagship render by the geodesic kernel (K1 on a card)."""
    scene, camera = _flagship_scene_camera(device)
    width = height = 64
    origins, dirs = cam.generate_rays(camera, width, height)

    def fn(origins, dirs, scene):
        hit = image.trace_rays_fast(origins.reshape(-1, 3),
                                    dirs.reshape(-1, 3), scene)
        return hit.color.reshape(height, width, 3)

    return fn, (origins, dirs, scene)


def dryrun_legs(mesh) -> dict:
    """The dry run on this rank of a mesh: its errors and loss (every
    rank returns the same numbers)."""
    n = mesh.size
    # Small but real shapes; the height divides by n.
    height = max(32, n)
    width = 32
    scene, camera = _flagship_scene_camera(mesh.device, max_steps=64,
                                           max_ray_distance=60.0)
    target = pmesh.render_image_sharded(scene, camera, width, height, mesh)
    # The geodesic kernel per shard (K1 on a card) must agree with the
    # XLA engine's sharded render.
    target_k = pmesh.render_image_sharded(scene, camera, width, height, mesh,
                                          engine="auto")
    err = float((target_k - target).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"kernel-per-shard mismatch: {err}")

    # The multi-tile leg: 120 x 16 max(n, 2) rays at 96 steps, each rank
    # ordering its own 1,920 rays by predicted depth.
    w2, h2 = 120, 16 * max(n, 2)
    scene2, camera2 = _flagship_scene_camera(mesh.device, max_steps=96,
                                             max_ray_distance=60.0)
    ref2 = pmesh.render_image_sharded(scene2, camera2, w2, h2, mesh)
    k2 = pmesh.render_image_sharded(scene2, camera2, w2, h2, mesh,
                                    engine="auto", depth_sort=True)
    err2 = float((k2 - ref2).abs().max())
    if not err2 < 1e-4:
        raise AssertionError(
            f"multi-tile depth-sorted kernel-per-shard mismatch: {err2}")

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.pack_params(scene, camera).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = pmesh.make_train_step_sharded(width, height, mesh)
    params, optimizer, loss = step(params, optimizer, target, scene, camera)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return {"n_ranks": n, "loss": loss, "err": err, "err2": err2,
            "w2": w2, "h2": h2}


def dryrun_multichip(n_ranks: int, device="cuda", timeout_s=600.0) -> dict:
    """One distributed inverse-rendering training step on a world of
    n_ranks spawned ranks (NCCL with a card per rank, gloo where ranks
    share one card or run on the CPU); prints the JAX package's summary
    line and returns rank 0's numbers."""
    r = launch.run_world(dryrun_legs, n_ranks, device=device,
                         timeout_s=timeout_s)[0]
    print_dryrun(n_ranks, r)
    return r


def print_dryrun(n_ranks: int, r: dict) -> None:
    """The JAX package's summary line of a dry run's numbers."""
    print(
        f"dryrun_multichip ok: {n_ranks} devices, loss={r['loss']:.3e}, "
        f"pallas-shard err={r['err']:.2e}, "
        f"multitile-sorted err={r['err2']:.2e} ({r['w2']}x{r['h2']}, "
        f"2 tiles/shard)"
    )
