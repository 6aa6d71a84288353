#!/usr/bin/env python3
"""Drive the PyTorch port's render and gradients once on one GPU and check them.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from this checkout's sources (one nvcc per
     library, started together) and print ptxas's registers and spills;
  3. K1 (trace_planes) against its plain PyTorch version on the card:
     64x64, spin 0 and 0.9, disk on and off, RK4 and RKF45, 250 steps,
     under the parity contracts (RK4: result codes equal, colour max
     < 2e-4 over agreeing non-MAX_STEPS rays; RKF45: at most n/500 codes
     differ, colour mean < 2e-3 and p99 < 3e-2);
  4. K2 (trace_planes_fwdgrad) against its plain version on the same
     cases with the tangents d/d(mass, spin), under K2's contract
     (fwdgrad_stats): the primal under K1's contracts and no result
     code differing from K1's; the colour tangents (clipped at
     TANGENT_CLIP, as the bench loss clips them) of the rays whose result
     code and step count agree, per ray, in mean and p99
     (TANGENT_LIMITS); RK4: the loss gradient sum(clip(d colour)) / 3n
     over those rays and over all rays within rtol 1e-3, atol 1e-7;
     RKF45, whose controller puts rounding noise into every tangent: the
     whole loss gradient within RKF45_GRAD_RTOL;
  5. K3: torch.func.jvp of the mean colour through trace_rays_kernel (the
     kernel runs K2 with one tangent) at the JAX package's check_jvp case
     (1024 rays, 200 steps, a = 0.9, disk on), d/dmass and d/dspin
     against the plain version within rtol 1e-3, atol 1e-7;
  6. depth-sorted traces equal raster traces bitwise at 256x256: the
     forward trace and the fwdgrad trace (hit and tangents);
  7. the forward half of the main path: image.render_image of the bench
     scene (Kerr a=0.9, disk 6-20, 1024x1024, RK4, 1000 steps) and its
     RKF45 tol 1e-6 variant at 512x512, K1's launches counted; then
     rays/s of trace_rays_fast (median of 3) and of the plain version at
     1024x1024, with K1 held to the plain version at that size;
  8. the gradient half of the main path (bench.py's fwd+bwd):
     grad.fast_grad.scene_value_and_grad over {mass, spin} of the bench
     loss sum(colour) / 3n with the depth order, at 1024x1024, RK4 1000
     steps and RKF45 tol 1e-6, launches counted; finite gradients;
     fwd+bwd rays/s (median of 3 after a warm-up, min and max); then K2
     at the main path's shapes against its plain version under K2's
     contract with the distribution contract on the primal: RK4 with two
     tangents and with one (K3) on all 1024x1024 rays, RKF45 with two
     tangents on every RKF45_SAMPLE-th ray of the kernel's 1024x1024
     pass (RKF45 also within RKF45_GRAD_RTOL on the whole gradient);
     CUDA-event times, bounds, and the result codes of K2's primal that
     differ from K1's.  The RK4 whole loss gradient's gap at 1024x1024 is
     reported, not gated: a few near-critical rays change their result
     code there.
The last three lines are the card, one JSON object about the kernels and
one JSON object with "ok" and the device.  Exits non-zero without a
result when no GPU is present or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
KERNELS = {
    "trace_planes": dict(
        route="cuda", source="blackhole_tpu_torch/csrc/trace_kernel.cu",
        replaces="blackhole_tpu/render/pallas_kernel.py:597"),
    "trace_planes_fwdgrad": dict(
        route="cuda", source="blackhole_tpu_torch/csrc/trace_fwdgrad.cu",
        replaces="blackhole_tpu/render/pallas_kernel.py:696 "
                 "(and :632 with one tangent)"),
}
# Floating-point operations per integration step (an FMA counts 2) of the
# kernels with the disk on, by (tangents, adaptive), K1 being 0 tangents:
# (the least the arithmetic needs, what the CUDA source executes).  The
# source spends more on 1 / sqrt (two, where one rsqrt does), on a Dual
# quotient (1 / (b b) and four operations per tangent, where the quotient
# rule spends three) and on a Dual max/min (a weighted sum of the tangents,
# where a select does).  Counted by running csrc's source on a counting
# float over the parity camera's rays (tests/test_torch_step.py,
# test_flops_per_step_match_chip_smoke, holds these numbers).  The bound
# takes the least; the executed count gives the FP32 issue share.
FLOPS_PER_STEP = {
    (0, False): (754.0, 756.0), (0, True): (1459.5, 1461.5),
    (1, False): (2456.0, 2560.0), (1, True): (4633.4, 4852.4),
    (2, False): (4141.0, 4294.0), (2, True): (7786.4, 8129.2),
}
# NVIDIA H100 SXM at its 700 W limit: FP32 outside the tensor cores and
# device memory bandwidth (data sheet).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# Colour tangents are winsorised at this value (grad.fast_grad).
TANGENT_CLIP = 15.0
# K2 against its plain version, per-ray colour tangents (clipped) of the
# rays whose result code and step count agree: limits on the mean and the
# p99 over those rays of each ray's largest difference over channels and
# tangents.  "steady": RK4 (measured at most 1.3e-4 and 1.4e-4, at
# 1024x1024, where a few near-critical rays differ by the whole clipped
# range).  "controller": RKF45, whose step-size controller puts rounding
# noise into every ray's tangent (below): the primal's distribution
# contract (measured at most 6.0e-4 and 1.03e-2).
TANGENT_LIMITS = {"steady": (1e-3, 1e-3), "controller": (2e-3, 3e-2)}
# RKF45 at tolerance 1e-6: the controller's error estimate |y5 - y4| is
# the difference of two nearly equal numbers, so its value and its
# tangent carry ~10% rounding noise, and d(h)/d(param) carries it into
# every ray's tangent, rays that take the same number of steps included;
# any rounding difference between two implementations (FMA contraction,
# rsqrt, jax.jvp's and torch's product rules) shows there: loss-gradient
# gaps 1.7e-4 to 4.8e-3 between K2 and its plain version on the card
# (5.4e-3 over the rays whose steps agree).  The whole loss gradient is
# held at RKF45_GRAD_RTOL, a backstop beside the tangents' contract.
RKF45_GRAD_RTOL = 1e-2
# The plain version integrates every RKF45_SAMPLE-th ray of the kernel's
# 1024x1024 RKF45 pass (rays are independent).
RKF45_SAMPLE = 64


def check(ok, what):
    """Every gate of the script: raise AssertionError(what) unless ok."""
    if not ok:
        raise AssertionError(what)


def parity_scene(spin, disk_enabled, integrator, device, size=64,
                 max_steps=250):
    """The parity case of the JAX package's compiled-kernel checks."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    scene = Scene(
        BlackHole.create(1.0, spin, device=device),
        Disk.create(6.0, 20.0, device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                         max_steps=max_steps, integrator=integrator,
                         device=device),
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
    trace_kernel.prepare and postprocess, the planes through K1's
    wrapper and through its plain version."""
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
    check(ok, f"kernel disagrees with plain: {stats}")
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


def mass_spin_tangents(scene):
    """Scene tangents d/dmass and d/dspin (torch.func.jvp of the map from
    the two parameters to the scene)."""
    import torch

    def build(m, a):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m, spin=a))

    m0, a0 = scene.blackhole.mass, scene.blackhole.spin
    one, zero = torch.ones_like(m0), torch.zeros_like(m0)
    return [torch.func.jvp(build, (m0, a0), (one, zero))[1],
            torch.func.jvp(build, (m0, a0), (zero, one))[1]]


def loss_grads(hit, dhits, clip=TANGENT_CLIP, rays=None):
    """The bench loss sum(colour) / 3n and its gradient along each hit
    tangent, with the colour tangent clipped (None: raw); rays: a mask
    of the rays the gradient sums over (all by default)."""
    n3 = hit.color.numel()
    grads = []
    for dh in dhits:
        dc = dh.color if clip is None else dh.color.clamp(-clip, clip)
        grads.append(float((dc if rays is None else dc[rays]).double().sum())
                     / n3)
    return float(hit.color.double().sum()) / n3, grads


def planes_args(scene):
    """(disk on, max steps, adaptive) of the planes pass of a scene."""
    return (bool(scene.disk_enabled and scene.config.show_disk),
            int(scene.config.max_steps), scene.config.integrator == "rkf45")


def fwdgrad_trace(o, d, scene, tangents, plain=False):
    """trace_rays_kernel_fwdgrad's host stages around K2 (or its plain
    version): (hit, [hit tangent per direction])."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    planes_in, finish = tk.prepare_fwdgrad(o, d, scene, tangents)
    fn = tk.trace_planes_fwdgrad_plain if plain else tk.trace_planes_fwdgrad
    return finish(*fn(*planes_in, *planes_args(scene)))


def grads_close(got, ref, rtol=1e-3, atol=1e-7):
    return all(abs(g - r) <= atol + rtol * abs(r) for g, r in zip(got, ref))


def fwdgrad_stats(kern, plain, exact, noise="steady", whole_rtol=None):
    """K2's contract against its plain version; kern and plain are
    (hit, [hit tangent]) of the same rays.  Raises on a breach of: the
    primal's parity contract (parity_stats); over the rays whose result
    code and step count agree, the mean and p99 of each ray's largest
    difference of clipped colour tangent (TANGENT_LIMITS[noise]) and,
    unless noise is "controller", the loss gradient summed over them
    (rtol 1e-3, atol 1e-7); the whole loss gradient within whole_rtol
    (None: reported only)."""
    import torch

    (hit_k, dh_k), (hit_p, dh_p) = kern, plain
    stats = parity_stats(hit_k, hit_p, exact)
    same = (hit_k.result == hit_p.result) & (hit_k.steps == hit_p.steps)
    clip = [[dh.color.clamp(-TANGENT_CLIP, TANGENT_CLIP) for dh in dhs]
            for dhs in (dh_k, dh_p)]
    err = torch.stack([(a - b).abs().amax(-1)
                       for a, b in zip(*clip)]).amax(0)[same].double().cpu()
    (_, g_k), (_, g_p) = (loss_grads(h, dhs) for h, dhs in
                          ((hit_k, dh_k), (hit_p, dh_p)))
    (_, s_k), (_, s_p) = (loss_grads(h, dhs, rays=same) for h, dhs in
                          ((hit_k, dh_k), (hit_p, dh_p)))
    stats.update({
        "same_steps": int(same.sum()),
        "tangent_mean": float(err.mean()),
        "tangent_p99": float(torch.quantile(err, 0.99)),
        "tangent_max": float(err.max()),
        "grad_same_kernel": s_k, "grad_same_plain": s_p,
        "grad_same_rel_err": max(abs(a - b) / max(abs(b), 1e-30)
                                 for a, b in zip(s_k, s_p)),
        "grad_kernel": g_k, "grad_plain": g_p,
        "grad_abs_err": max(abs(a - b) for a, b in zip(g_k, g_p)),
        "grad_rel_err": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(g_k, g_p)),
    })
    mean, p99 = TANGENT_LIMITS[noise]
    check(stats["tangent_mean"] < mean and stats["tangent_p99"] < p99,
          f"K2's tangents disagree with plain: {stats}")
    check(noise == "controller" or grads_close(s_k, s_p),
          f"K2's loss gradient over the rays whose steps agree disagrees "
          f"with plain: {stats}")
    if whole_rtol is not None:
        check(grads_close(g_k, g_p, rtol=whole_rtol),
              f"K2's loss gradient disagrees with plain: {stats}")
    return stats


def check_fwdgrad_vs_plain(device, size=64, integrators=("rk4", "rkf45")):
    """Phase 4; returns one stats dict per case."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    out = []
    for integ in integrators:
        for spin, disk in ((0.0, True), (0.9, True), (0.9, False)):
            scene, _, o, d = parity_scene(spin, disk, integ, device, size)
            tangents = mass_spin_tangents(scene)
            kern, plain = (fwdgrad_trace(o, d, scene, tangents, p)
                           for p in (False, True))
            rkf45 = integ == "rkf45"
            stats = fwdgrad_stats(
                kern, plain, exact=not rkf45,
                noise="controller" if rkf45 else "steady",
                whole_rtol=RKF45_GRAD_RTOL if rkf45 else 1e-3)
            vs_k1 = int((kern[0].result
                         != tk.trace_rays_kernel(o, d, scene).result).sum())
            check(vs_k1 == 0, f"K2's primal differs from K1's in {vs_k1} "
                  f"result codes")
            out.append({"integrator": integ, "spin": spin, "disk": disk,
                        "codes_vs_k1": vs_k1, **stats})
    return out


def check_k3(device):
    """Phase 5: torch.func.jvp of the mean colour through trace_rays_kernel
    against the plain version, at check_jvp's case."""
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    scene, _, o, d = parity_scene(0.9, True, "rk4", device, 64,
                                  max_steps=200)
    o, d = o[:1024], d[:1024]
    m0, a0 = scene.blackhole.mass, scene.blackhole.spin

    def loss(m, a):
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m, spin=a))
        hit = tk.trace_rays_kernel(o, d, s)
        return hit.color.sum() / hit.color.numel()

    one, zero = torch.ones_like(m0), torch.zeros_like(m0)
    before = tk.fwdgrad_launches
    got = [float(torch.func.jvp(loss, (m0, a0), t)[1])
           for t in ((one, zero), (zero, one))]
    launches = tk.fwdgrad_launches - before
    check(launches == 2, f"jvp launched K2 {launches} times, not 2")
    ref = [loss_grads(*fwdgrad_trace(o, d, scene, [tan], plain=True),
                      clip=None)[1][0] for tan in mass_spin_tangents(scene)]
    check(grads_close(got, ref), f"K3 jvp: gradient {got} vs plain {ref}")
    return {"dmass_kernel": got[0], "dmass_plain": ref[0],
            "dspin_kernel": got[1], "dspin_plain": ref[1],
            "k2_launches": launches}


def _hits_equal(a, b):
    return sum(int((getattr(a, f.name) != getattr(b, f.name)).sum())
               for f in dataclasses.fields(a))


def check_depth_sorted(device, size=256):
    """Phase 6: depth-sorted traces equal the raster ones bitwise."""
    import torch

    from blackhole_tpu_torch.render import image, trace_kernel

    scene, camera, o, d = parity_scene(0.9, True, "rk4", device, size)
    order = image.predicted_depth_order(scene, camera, size, size)
    check(torch.equal(torch.sort(order).values,
                      torch.arange(size * size, device=order.device)),
          "depth order is not a permutation")
    mism = _hits_equal(trace_kernel.trace_rays_kernel(o, d, scene),
                       trace_kernel.trace_rays_kernel(o, d, scene,
                                                      order=order))
    tangents = mass_spin_tangents(scene)
    raster = trace_kernel.trace_rays_kernel_fwdgrad(o, d, scene, tangents)
    ordered = trace_kernel.trace_rays_kernel_fwdgrad(o, d, scene, tangents,
                                                     order=order)
    mism_grad = sum(_hits_equal(a, b) for a, b in
                    zip([raster[0], *raster[1]], [ordered[0], *ordered[1]]))
    check(not (mism or mism_grad), f"depth-sorted traces differ: forward "
          f"{mism}, fwdgrad {mism_grad} values")
    return {"n_rays": size * size, "elementwise_mismatch": mism,
            "fwdgrad_elementwise_mismatch": mism_grad}


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


def bound_ms(n_tan, adaptive, steps_plane, n_rays):
    """The least time the card could take for a planes pass: the larger
    of its operations (the least per-step count times this run's steps)
    over the FP32 rate and its bytes (inputs read once, outputs written
    once) over the memory rate.  Returns (ms, "operations" or "bytes",
    the executed operations' time in ms at the FP32 rate)."""
    steps = float(steps_plane.double().sum())
    least, executed = (c * steps for c in FLOPS_PER_STEP[(n_tan, adaptive)])
    nbytes = 4 * ((1 + n_tan) * (12 + 16 * n_rays) + (1 + n_tan) * 15 * n_rays)
    t_ops, t_bytes = least / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * executed / FP32_FLOPS)


def print_bound(what, ms, bound):
    b_ms, by, issue_ms = bound
    print(f"{what} bound: {b_ms:.3f} ms ({by}), {100 * b_ms / ms:.1f}% of it "
          f"reached; FP32 issue of the executed operations "
          f"{100 * issue_ms / ms:.1f}%")


def check_fwdgrad_main_shapes(o, d, scene, scene45, k1_planes, k1_ms):
    """Phase 8's K2 checks at the main path's shapes, given K1's planes
    and time for the same rays of `scene`; prints times and bounds and
    returns K2's row of the kernels line."""
    from blackhole_tpu_torch.render import trace_kernel

    n = o.shape[0]
    args = planes_args(scene)
    # K2 against its plain version at the main path's shapes (raster
    # order: the depth order changes no value, phase 6).
    (scal, dscals, inp, dinps), finish = trace_kernel.prepare_fwdgrad(
        o, d, scene, mass_spin_tangents(scene))
    runs = [_cuda_ms(lambda: trace_kernel.trace_planes_fwdgrad(
        scal, dscals, inp, dinps, *args)) for _ in range(3)]
    k2_planes = runs[0][0]
    ms_k2 = statistics.median(ms for _, ms in runs)
    p2_planes, ms_p2 = _cuda_ms(
        lambda: trace_kernel.trace_planes_fwdgrad_plain(
            scal, dscals, inp, dinps, *args))
    print(f"K2 planes 1024^2 rk4 (2 tangents): kernel {ms_k2:.3f} ms "
          f"({ms_k2 / k1_ms:.2f}x K1), plain {ms_p2:.3f} ms")
    k2_bound = bound_ms(2, False, k2_planes[0][2], n)
    print_bound("K2 1024^2 rk4", ms_k2, k2_bound)
    out_k = k2_planes[0]
    k2_vs_k1 = int((out_k[0] != k1_planes[0]).sum())
    print(f"K2 primal vs K1 1024^2 rk4: {k2_vs_k1} of {n} result codes "
          f"differ, {int((out_k != k1_planes).sum())} of {k1_planes.numel()} "
          f"plane values")
    big2 = fwdgrad_stats(finish(*k2_planes), finish(*p2_planes),
                         exact=False)
    print(f"parity K2 1024^2 rk4: {json.dumps(big2)}")
    # K3: the same kernel with one tangent (d/dmass).
    runs = [_cuda_ms(lambda: trace_kernel.trace_planes_fwdgrad(
        scal, dscals[:1], inp, dinps[:1], *args)) for _ in range(3)]
    ms_k3 = statistics.median(ms for _, ms in runs)
    p3_planes, ms_p3 = _cuda_ms(
        lambda: trace_kernel.trace_planes_fwdgrad_plain(
            scal, dscals[:1], inp, dinps[:1], *args))
    print(f"K3 (K2, 1 tangent) planes 1024^2 rk4: kernel {ms_k3:.3f} ms "
          f"({ms_k3 / k1_ms:.2f}x K1), plain {ms_p3:.3f} ms")
    print_bound("K3 1024^2 rk4", ms_k3,
                bound_ms(1, False, runs[0][0][0][2], n))
    big3 = fwdgrad_stats(finish(*runs[0][0]), finish(*p3_planes),
                         exact=False)
    print(f"parity K3 1024^2 rk4: {json.dumps(big3)}")
    # RKF45: the kernel on all rays, the plain version on a sample.
    tangents45 = mass_spin_tangents(scene45)
    (scal, dscals, inp, dinps), _ = trace_kernel.prepare_fwdgrad(
        o, d, scene45, tangents45)
    args45 = planes_args(scene45)
    runs = [_cuda_ms(lambda: trace_kernel.trace_planes_fwdgrad(
        scal, dscals, inp, dinps, *args45)) for _ in range(3)]
    ms_k45 = statistics.median(ms for _, ms in runs)
    every = slice(None, None, RKF45_SAMPLE)
    k45 = (runs[0][0][0][:, every], runs[0][0][1][:, :, every])
    _, finish45 = trace_kernel.prepare_fwdgrad(o[every], d[every], scene45,
                                               tangents45)
    p45, ms_p45 = _cuda_ms(lambda: trace_kernel.trace_planes_fwdgrad_plain(
        scal, dscals, inp[:, every].contiguous(),
        dinps[:, :, every].contiguous(), *args45))
    print(f"K2 planes 1024^2 rkf45 (2 tangents): kernel {ms_k45:.3f} ms; "
          f"plain on every {RKF45_SAMPLE}th ray {ms_p45:.3f} ms")
    print_bound("K2 1024^2 rkf45", ms_k45,
                bound_ms(2, True, runs[0][0][0][2], n))
    big45 = fwdgrad_stats(finish45(*k45), finish45(*p45), exact=False,
                          noise="controller", whole_rtol=RKF45_GRAD_RTOL)
    print(f"parity K2 1024^2 rkf45 (every {RKF45_SAMPLE}th ray): "
          f"{json.dumps(big45)}")
    return {"max_abs_err": max(
        max(b["color_max"], b["tangent_max"]) for b in (big2, big3, big45)),
        "ms": ms_k2, "plain_ms": ms_p2, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None}


def _timed(fn, repeats=3):
    """Wall seconds of fn() to a synchronise: one warm-up, then repeats."""
    import torch

    times = []
    for _ in range(1 + repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return res, times[1:]


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

    # 2. Build the kernels from this checkout's sources.
    from blackhole_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    libs = cuda_lib.build()
    for name in libs:
        cuda_lib.load(name)
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        variant = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"(trace_kernel|fwdgrad_kernel)I(Li\d+E)?"
                          r"Lb(\d)ELb(\d)E", line)
            if m and "Compiling entry function" in line:
                tan = m[2][2:-1] if m[2] else "0"
                variant = f"{m[1]} tangents={tan} disk={m[3]} adaptive={m[4]}"
            elif "registers" in line or "spill" in line:
                print(f"ptxas {variant}: {line.split(':', 1)[-1].strip()}")

    # 3. K1 against plain on the card.
    for stats in check_kernel_vs_plain(dev):
        print(f"parity K1: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 4")
    # 4. K2 against plain on the card.
    fwd_stats = check_fwdgrad_vs_plain(dev)
    for stats in fwd_stats:
        print(f"parity K2: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 5")
    # 5. K3: jvp through the trace.
    print(f"K3 jvp: {json.dumps(check_k3(dev))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 6")
    # 6. Depth-sorted against raster.
    print(f"depth-sorted: {json.dumps(check_depth_sorted(dev))}")

    from blackhole_tpu_torch.geom.types import RayResult
    from blackhole_tpu_torch.grad import fast_grad
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel

    print(f"[{time.perf_counter() - T0:.1f} s] phase 7")
    # 7. The forward half of the main path.
    scene, camera = bench_scene(dev)
    scene45, _ = bench_scene(dev, "rkf45")
    trace_kernel.launches = trace_kernel.fwdgrad_launches = 0
    t0 = time.perf_counter()
    img = image.render_image(scene, camera, 1024, 1024, engine="auto")
    img45 = image.render_image(scene45, camera, 512, 512, engine="auto")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    fwd_launches = (trace_kernel.launches, trace_kernel.fwdgrad_launches)
    print(f"main path (forward): render_image 1024^2 rk4 + 512^2 rkf45 in "
          f"{main_s:.3f} s, launches K1 {fwd_launches[0]} K2 "
          f"{fwd_launches[1]}")
    check(fwd_launches[0] >= 1, "the forward path launched no K1")
    for name, im, size in (("rk4", img, 1024), ("rkf45", img45, 512)):
        check(im.shape == (size, size, 3) and bool(torch.isfinite(im).all()),
              f"{name} image is not finite {size}^2 RGB")
        print(f"image {name}: mean {float(im.mean()):.6f}")

    o, d = cam.generate_rays(camera, 1024, 1024)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = o.shape[0]
    hit, times = _timed(lambda: image.trace_rays_fast(o, d, scene))
    t_kernel = statistics.median(times)
    codes = set(torch.unique(hit.result).tolist())
    # Rays that pass the hole run out of path budget (150) before their
    # radius reaches 150 in this scene: they end as MAX_DISTANCE.  Rays
    # aimed away from the hole reach the radius first: BACKGROUND.
    away = image.trace_rays_fast(o[::256], -d[::256], scene)
    codes |= set(torch.unique(away.result).tolist())
    need = {RayResult.HORIZON, RayResult.DISK, RayResult.BACKGROUND,
            RayResult.MAX_DISTANCE}
    check(need <= codes, f"result codes {codes} lack some of {need}")
    print(f"result codes: {sorted(codes)}")
    print(f"trace_rays_fast kernel 1024^2 rk4: {n / t_kernel:.1f} rays/s "
          f"(median of 3: {[round(t, 4) for t in times]} s)")

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
    print(f"K1 planes 1024^2 rk4: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
    k1_bound = bound_ms(0, False, planes_k[2], n)
    print(f"K1 steps 1024^2 rk4: sum {float(planes_k[2].double().sum()):.0f}")
    print_bound("K1 1024^2 rk4", ms_k, k1_bound)
    hits = [trace_kernel.postprocess(p, n, (n,), scene, None, inp[5])
            for p in (planes_k, planes_p)]
    # A million rays include near-critical ones on which an ulp of
    # difference (FMA contraction, rsqrt rounding) changes the orbit, so
    # the full-size check holds the distribution contract.
    big = parity_stats(hits[0], hits[1], exact=False)
    print(f"parity K1 1024^2 rk4 (distribution contract): {json.dumps(big)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 8")
    # 8. The gradient half of the main path (bench.py's fwd+bwd).
    def loss_of_hit(h):
        return h.color.sum() / h.color.numel()

    def scene_fn_of(base):
        def scene_fn(p):
            return dataclasses.replace(base, blackhole=dataclasses.replace(
                base.blackhole, mass=p["mass"], spin=p["spin"]))
        return scene_fn

    params = {"mass": torch.tensor(1.0, device=dev),
              "spin": torch.tensor(0.9, device=dev)}

    def fwdbwd(base):
        scene_fn = scene_fn_of(base)
        vg = fast_grad.scene_value_and_grad(loss_of_hit, scene_fn)
        order = image.predicted_depth_order(scene_fn(params), camera, 1024,
                                            1024)
        return vg(params, o, d, order=order)

    trace_kernel.launches = trace_kernel.fwdgrad_launches = 0
    t0 = time.perf_counter()
    grad_runs = {name: fwdbwd(base)
                 for name, base in (("rk4", scene), ("rkf45", scene45))}
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = (trace_kernel.launches, trace_kernel.fwdgrad_launches)
    print(f"main path (gradient): scene_value_and_grad 1024^2 rk4 + rkf45 in "
          f"{grad_s:.3f} s, launches K1 {grad_launches[0]} K2 "
          f"{grad_launches[1]}")
    check(grad_launches[1] >= 1, "the gradient path launched no K2")
    for name, (loss, grads) in grad_runs.items():
        g = [float(grads["mass"]), float(grads["spin"])]
        check(all(math.isfinite(x) for x in g),
              f"{name} gradients are not finite: {g}")
        print(f"gradient {name} 1024^2: loss {float(loss):.9f} "
              f"d/dmass {g[0]:.9e} d/dspin {g[1]:.9e}")
    for name, base in (("rk4", scene), ("rkf45", scene45)):
        _, times = _timed(lambda: fwdbwd(base))
        print(f"fwd+bwd {name} 1024^2 (2 tangents, depth order): "
              f"{n / statistics.median(times):.1f} rays/s median of 3 "
              f"(min {n / max(times):.1f}, max {n / min(times):.1f}; "
              f"{[round(t, 4) for t in times]} s)")

    k2 = check_fwdgrad_main_shapes(o, d, scene, scene45, planes_k, ms_k)
    print(f"[{time.perf_counter() - T0:.1f} s] phase 8 done")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "trace_planes", **KERNELS["trace_planes"],
         "launches": fwd_launches[0], "max_abs_err": big["color_max"],
         "ms": ms_k, "plain_ms": ms_p, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "trace_planes_fwdgrad", **KERNELS["trace_planes_fwdgrad"],
         **k2, "launches": grad_launches[1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
