"""Scaling harness: sharded rays/s against the number of ranks.

PyTorch counterpart of the JAX package's bench_scaling.py.  Runs the
sharded render (parallel.mesh.render_image_sharded, the XLA engine) and
its fwd+bwd (loss_and_grad_sharded) in worlds of 1, 2, 4, ... ranks on
this host (parallel.launch.run_world) and reports efficiency against
the first world.

Two columns, as in the JAX harness:
* wall: rays/s by the wall clock of the world's slowest rank, per rank,
  against the first world's.  The number that matters where each rank
  has its own card.
* cpu: rays per CPU-second summed over the ranks (process time).
  Where ranks share cores or a card, this measures the total work the
  sharded program does per ray.  The eager XLA engine pays a host cost
  per operation whatever the batch, so every rank pays each step's host
  cost again: per-CPU-second efficiency falls toward 1/n by
  construction, and it is printed, not gated.

Each world size prints one JSON line; the summary follows (--json
writes it to a file).

    python -m blackhole_tpu_torch.parallel.scaling --sizes 1,2 \
        --device cpu
Ranks on a card use NCCL while there is a card per rank, and gloo (two
ranks sharing one card) otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.grad import inverse
from blackhole_tpu_torch.parallel import launch
from blackhole_tpu_torch.parallel import mesh as pmesh


def _make_scene(k: int, steps: int, device):
    """The bench scene at path budget 60; mass moves by 1e-6 k so no
    repeat reuses an earlier one's result."""
    return Scene(
        blackhole=BlackHole.create(1.0 + 1e-6 * k, 0.9, device=device),
        disk=Disk.create(6.0, 20.0, 1.0, 1.0, device=device),
        config=SimConfig.create(time_step=0.1, max_ray_distance=60.0,
                                max_steps=steps, device=device),
        disk_enabled=True,
    )


def _camera(device):
    return Camera.create(position=(0.0, -35.0, 12.0),
                         direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                         fov_deg=22.0, device=device)


def _clocked(fn, repeats, sync):
    """Best (wall, process CPU) seconds of repeats calls after a warm-up."""
    fn(0)
    sync()
    best_wall, best_cpu = float("inf"), float("inf")
    for k in range(repeats):
        t0w, t0c = time.perf_counter(), time.process_time()
        fn(k + 1)
        sync()
        best_wall = min(best_wall, time.perf_counter() - t0w)
        best_cpu = min(best_cpu, time.process_time() - t0c)
    return best_wall, best_cpu


def _rank_job(mesh, width, height, steps, repeats, fwdbwd):
    """One rank's share of a world's measurement: its best wall and CPU
    seconds per phase and the first forward image."""
    dev = mesh.device
    camera = _camera(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    image = pmesh.render_image_sharded(_make_scene(0, steps, dev), camera,
                                       width, height, mesh)
    out = {"image": image.cpu().numpy()}
    out["fwd"] = _clocked(
        lambda k: pmesh.render_image_sharded(_make_scene(k, steps, dev),
                                             camera, width, height, mesh),
        repeats, sync)
    if fwdbwd:
        scene0 = _make_scene(0, steps, dev)

        def run_vg(k):
            params = inverse.pack_params(_make_scene(-k, steps, dev), camera)
            pmesh.loss_and_grad_sharded(params, image, scene0, camera, width,
                                        height, mesh)

        out["fwdbwd"] = _clocked(run_vg, repeats, sync)
    return out


def measure(width, height, steps, sizes, repeats, fwdbwd, device="cuda"):
    """Records of worlds of the given sizes: rays/s by wall clock and per
    CPU-second, and efficiencies against the first world.  The result
    also holds each world's forward image (images, not printed)."""
    n_rays = width * height
    dev_type = torch.device(device).type
    records, images = [], {}
    for nd in sizes:
        ranks = launch.run_world(_rank_job, nd, device=device,
                                 args=(width, height, steps, repeats,
                                       fwdbwd))
        images[nd] = ranks[0]["image"]
        rec = {"mesh": nd}
        for phase in ("fwd", "fwdbwd") if fwdbwd else ("fwd",):
            wall = max(r[phase][0] for r in ranks)
            cpu = sum(r[phase][1] for r in ranks)
            rec[f"{phase}_rays_per_s_wall"] = round(n_rays / wall, 1)
            rec[f"{phase}_rays_per_cpu_s"] = round(n_rays / cpu, 1)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    base = records[0]
    for rec in records:
        n = rec["mesh"] / base["mesh"]
        for phase in ("fwd", "fwdbwd") if fwdbwd else ("fwd",):
            rec[f"eff_{phase}_wall"] = round(
                rec[f"{phase}_rays_per_s_wall"]
                / (n * base[f"{phase}_rays_per_s_wall"]), 3)
            rec[f"eff_{phase}_cpu"] = round(
                rec[f"{phase}_rays_per_cpu_s"]
                / base[f"{phase}_rays_per_cpu_s"], 3)

    return {
        "platform": dev_type,
        "device": (torch.cuda.get_device_name(0) if dev_type == "cuda"
                   else "cpu"),
        "physical_cores": os.cpu_count(),
        "width": width,
        "height": height,
        "max_steps": steps,
        "records": records,
        "images": images,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=None, help="write full record here")
    ap.add_argument("--no-fwdbwd", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="each rank's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    out = measure(args.width, args.height, args.steps, sizes, args.repeats,
                  fwdbwd=not args.no_fwdbwd, device=args.device)
    out.pop("images")
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
