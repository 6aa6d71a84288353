"""Sharded rendering + a distributed inverse-rendering step over ranks.

Image rows are sharded over a world of ranks on this host
(parallel.launch.run_world: NCCL with a card per rank, gloo on the CPU
or where ranks share a card), and the gradient is one all_reduce:

    python -m blackhole_tpu_torch.examples.distributed_render --world 2 \
        --device cpu

Across hosts: call parallel.mesh.initialize_distributed(init_method,
world_size, rank) on every process and make_mesh() there; the same
calls then span the hosts.
"""

import argparse

import torch

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.grad import inverse
from blackhole_tpu_torch.parallel import launch
from blackhole_tpu_torch.parallel import mesh as pmesh


def _scene_camera(device):
    scene = Scene(
        blackhole=BlackHole.create(1.0, 0.9, device=device),
        disk=Disk.create(6.0, 20.0, device=device),
        config=SimConfig.create(
            time_step=0.1, max_ray_distance=80.0, max_steps=256,
            device=device
        ),
        disk_enabled=True,
    )
    camera = Camera.create(
        position=(0.0, -35.0, 12.0),
        direction=(0.0, 35.0, -12.0),
        up=(0.0, 0.0, 1.0),
        fov_deg=22.0,
        device=device,
    )
    return scene, camera


def rank_main(mesh):
    """One rank's share: the sharded render and one training step."""
    n = mesh.size
    scene, camera = _scene_camera(mesh.device)
    height = 64 - (64 % n) or n
    target = pmesh.render_image_sharded(scene, camera, 64, height, mesh)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.pack_params(scene, camera).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = pmesh.make_train_step_sharded(64, height, mesh)
    params, optimizer, loss = step(params, optimizer, target, scene, camera)
    return {"image": target.cpu(), "loss": float(loss),
            "rows_per_rank": height // n}


def main(argv=None):
    """Returns (image (H, 64, 3) on the host, loss) from rank 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: one per card, 1 on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    world = args.world or (max(torch.cuda.device_count(), 1) if on_card
                           else 1)
    print(f"ranks: {world} x {args.device}")
    r = launch.run_world(rank_main, world, device=args.device)[0]
    print(f"sharded render: {tuple(r['image'].shape)}, "
          f"{r['rows_per_rank']} rows per rank")
    print(f"one distributed fwd+bwd step: loss={r['loss']:.3e}")
    return r["image"], r["loss"]


if __name__ == "__main__":
    main()
