#!/usr/bin/env python3
"""Drive the PyTorch port's forward render once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA geodesic kernel from this checkout's sources;
  3. kernel against its plain PyTorch version on the card: 64x64, spin 0
     and 0.9, disk on and off, RK4 and RKF45, 250 steps, under the
     parity contracts (RK4: result codes equal, colour max < 2e-4 over
     agreeing non-MAX_STEPS rays; RKF45: at most n/500 codes differ,
     colour mean < 2e-3 and p99 < 3e-2);
  4. a depth-sorted trace equals the raster trace bitwise at 256x256;
  5. the main path: image.render_image of the bench scene (Kerr a=0.9,
     disk 6-20, 1024x1024, RK4, 1000 steps) and its RKF45 tol 1e-6
     variant at 512x512; the kernel's launch counter must rise, the
     images be finite and the result codes include HORIZON, DISK and
     BACKGROUND; then rays/s of trace_rays_fast (median of 3) and of the
     plain version at 1024x1024, with the kernel checked against the
     plain version at that size.
The last two lines are one JSON object about the kernel and one JSON
object with "ok" and the device.  Exits non-zero without a result when
no GPU is present or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "blackhole_tpu_torch/csrc/trace_kernel.cu"
REPLACES = "blackhole_tpu/render/pallas_kernel.py:597"


def parity_scene(spin, disk_enabled, integrator, device, size=64):
    """The parity case of the JAX package's compiled-kernel checks."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    scene = Scene(
        BlackHole.create(1.0, spin, device=device),
        Disk.create(6.0, 20.0, device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=80.0, max_steps=250,
                         integrator=integrator, device=device),
        disk_enabled=disk_enabled,
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, device=device)
    o, d = cam.generate_rays(camera, size, size)
    return scene, camera, o.reshape(-1, 3), d.reshape(-1, 3)


def bench_scene(device, integrator="rk4"):
    """bench.py's scene: Kerr a=0.9, disk 6-20, 1000 steps, budget 150."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )

    scene = Scene(
        BlackHole.create(1.0, 0.9, device=device),
        Disk.create(6.0, 20.0, 1.0, 1.0, device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=150.0,
                         max_steps=1000, integrator=integrator,
                         tolerance=1e-6, device=device),
    )
    camera = Camera.create(position=(0.0, -35.0, 12.0),
                           direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                           fov_deg=22.0, device=device)
    return scene, camera


def kernel_and_plain(o, d, scene):
    """(kernel Hit, plain Hit) for the same rays: both go through
    trace_kernel.prepare and postprocess, the planes through the CUDA
    kernel's wrapper and through the plain version."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    adaptive = scene.config.integrator == "rkf45"
    disk = bool(scene.disk_enabled and scene.config.show_disk)
    scal, inp = tk.prepare(o, d, scene)
    args = (disk, scene.config.max_steps, adaptive)
    hits = []
    for planes in (tk.trace_planes(scal, inp, *args),
                   tk.trace_planes_plain(scal, inp, *args)):
        hits.append(tk.postprocess(planes, o.shape[0], (o.shape[0],), scene,
                                   None, inp[5]))
    return hits


def parity_stats(hit_k, hit_p, exact):
    """The parity contract of kernel against plain; raises on a breach.

    exact (the RK4 contract at the parity case): result codes equal and
    colour max < 2e-4 over agreeing non-MAX_STEPS rays.  Otherwise the
    distribution contract: at most n/500 codes differ, colour mean < 2e-3
    and p99 < 3e-2 over agreeing non-MAX_STEPS rays."""
    import torch

    from blackhole_tpu_torch.geom.types import RayResult

    agree = hit_k.result == hit_p.result
    dc = (hit_k.color - hit_p.color).abs().amax(-1)
    mask = agree & (hit_p.result != RayResult.MAX_STEPS)
    dc = (dc[mask] if bool(mask.any()) else dc).double().cpu()
    n = hit_p.result.numel()
    stats = {
        "n_rays": n,
        "result_mismatch": int((~agree).sum()),
        "color_mean": float(dc.mean()),
        "color_p99": float(torch.quantile(dc, 0.99)),
        "color_max": float(dc.max()),
        "color_over_2e-4": int((dc >= 2e-4).sum()),
    }
    if exact:
        ok = stats["result_mismatch"] == 0 and stats["color_max"] < 2e-4
    else:
        ok = (stats["result_mismatch"] <= max(1, n // 500)
              and stats["color_mean"] < 2e-3 and stats["color_p99"] < 3e-2)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {stats}")
    return stats


def check_kernel_vs_plain(device, size=64):
    """Phase 3; returns one stats dict per case."""
    out = []
    for integ in ("rk4", "rkf45"):
        for spin, disk in ((0.0, True), (0.9, True), (0.9, False)):
            scene, _, o, d = parity_scene(spin, disk, integ, device, size)
            hit_k, hit_p = kernel_and_plain(o, d, scene)
            stats = parity_stats(hit_k, hit_p, exact=integ == "rk4")
            out.append({"integrator": integ, "spin": spin, "disk": disk,
                        **stats})
    return out


def check_depth_sorted(device, size=256):
    """Phase 4: a depth-sorted kernel trace equals the raster one bitwise."""
    import torch

    from blackhole_tpu_torch.render import image, trace_kernel

    scene, camera, o, d = parity_scene(0.9, True, "rk4", device, size)
    order = image.predicted_depth_order(scene, camera, size, size)
    if not torch.equal(torch.sort(order).values,
                       torch.arange(size * size, device=order.device)):
        raise AssertionError("depth order is not a permutation")
    hit_r = trace_kernel.trace_rays_kernel(o, d, scene)
    hit_s = trace_kernel.trace_rays_kernel(o, d, scene, order=order)
    mism = 0
    for f in dataclasses.fields(hit_r):
        mism += int((getattr(hit_r, f.name) != getattr(hit_s, f.name)).sum())
    if mism:
        raise AssertionError(f"depth-sorted trace differs in {mism} values")
    return {"n_rays": size * size, "elementwise_mismatch": mism}


def _cuda_ms(fn):
    """(result, milliseconds) of one call, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop)


def main() -> int:
    if not (ROOT / "blackhole_tpu_torch").is_dir():
        print("chip_smoke: blackhole_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 2. Build the kernel from this checkout's sources.
    from blackhole_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    variant = "?"
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"trace_kernelILb(\d)ELb(\d)E", line)
        if m and "Compiling entry function" in line:
            variant = f"disk={m[1]} adaptive={m[2]}"
        elif "registers" in line or "spill" in line:
            print(f"ptxas {variant}: {line.split(':', 1)[-1].strip()}")

    # 3. Kernel against plain on the card.
    for stats in check_kernel_vs_plain(dev):
        print(f"parity: {json.dumps(stats)}")

    # 4. Depth-sorted against raster.
    print(f"depth-sorted: {json.dumps(check_depth_sorted(dev))}")

    # 5. The main path.
    from blackhole_tpu_torch.geom.types import RayResult
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel

    scene, camera = bench_scene(dev)
    scene45, _ = bench_scene(dev, "rkf45")
    trace_kernel.launches = 0
    t0 = time.perf_counter()
    img = image.render_image(scene, camera, 1024, 1024, engine="auto")
    img45 = image.render_image(scene45, camera, 512, 512, engine="auto")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = trace_kernel.launches
    print(f"main path: render_image 1024^2 rk4 + 512^2 rkf45 in "
          f"{main_s:.3f} s, {launches} kernel launches")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    for name, im, size in (("rk4", img, 1024), ("rkf45", img45, 512)):
        if im.shape != (size, size, 3) or not bool(torch.isfinite(im).all()):
            raise AssertionError(f"{name} image is not finite {size}^2 RGB")
        print(f"image {name}: mean {float(im.mean()):.6f}")

    o, d = cam.generate_rays(camera, 1024, 1024)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = o.shape[0]
    times = []
    for _ in range(4):  # one warm-up, three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = image.trace_rays_fast(o, d, scene)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_kernel = statistics.median(times[1:])
    codes = set(torch.unique(hit.result).tolist())
    # Rays that pass the hole run out of path budget (150) before their
    # radius reaches 150 in this scene: they end as MAX_DISTANCE.  Rays
    # aimed away from the hole reach the radius first: BACKGROUND.
    away = image.trace_rays_fast(o[::256], -d[::256], scene)
    codes |= set(torch.unique(away.result).tolist())
    need = {RayResult.HORIZON, RayResult.DISK, RayResult.BACKGROUND,
            RayResult.MAX_DISTANCE}
    if not need <= codes:
        raise AssertionError(f"result codes {codes} lack some of {need}")
    print(f"result codes: {sorted(codes)}")
    print(f"trace_rays_fast kernel 1024^2 rk4: {n / t_kernel:.1f} rays/s "
          f"(median of 3: {[round(t, 4) for t in times[1:]]} s)")

    scal, inp = trace_kernel.prepare(o, d, scene)
    args = (True, scene.config.max_steps, False)
    runs = [_cuda_ms(lambda: trace_kernel.trace_planes(scal, inp, *args))
            for _ in range(3)]
    planes_k = runs[0][0]
    ms_k = statistics.median(ms for _, ms in runs)
    t0 = time.perf_counter()
    planes_p, ms_p = _cuda_ms(lambda: trace_kernel.trace_planes_plain(
        scal, inp, *args))
    t_plain = time.perf_counter() - t0
    print(f"plain version 1024^2 rk4 (planes only): {n / t_plain:.1f} rays/s")
    print(f"geodesic planes 1024^2 rk4: kernel {ms_k:.3f} ms, "
          f"plain {ms_p:.3f} ms")
    hits = [trace_kernel.postprocess(p, n, (n,), scene, None, inp[5])
            for p in (planes_k, planes_p)]
    # A million rays include near-critical ones on which an ulp of
    # difference (FMA contraction, rsqrt rounding) changes the orbit, so
    # the full-size check holds the distribution contract.
    big = parity_stats(hits[0], hits[1], exact=False)
    print(f"parity 1024^2 rk4 (distribution contract): {json.dumps(big)}")

    print(json.dumps({"kernels": [{
        "name": "trace_planes", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": big["color_max"], "ms": ms_k, "plain_ms": ms_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
