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
     cases (RK4 over FWDGRAD_PARITY_STEPS' 125 steps) with the tangents
     d/d(mass, spin) (with the disk on, the first
     15 planes of the plain tracking pass), under K2's contract
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
  5b. K1 and K2 (d/d(mass, spin)) after 1 and 2 steps from the same
     64x64 parity states, RK4 and RKF45, disk off, on and tracking, and
     after 2 steps from the controller states (RKF45, every first step
     rejected), against their plain versions (check_one_step: codes and
     step counts equal; every plane within ONE_STEP_TOL of the CPU twin's
     contract, the last chord direction's tangent within
     ONE_STEP_CHORD_TOL; after a step that used the RKF45 controller's
     output, the medians, and per ray the rays whose step a clamp of the
     controller set);
  6. depth-sorted traces equal raster traces bitwise at 256x256: the
     forward trace and the fwdgrad trace (hit and tangents);
  7. the forward half of the main path: image.render_image of the bench
     scene (Kerr a=0.9, disk 6-20, 1024x1024, RK4, 1000 steps) and its
     RKF45 tol 1e-6 variant at 512x512, K1's launches counted; then
     rays/s of trace_rays_fast (median of 3) and of the plain version at
     1024x1024, with K1 held to the plain version at that size; K1's
     times and bounds for render_image's prepasses (128x128 RK4, 64x64
     RKF45) and its 512x512 RKF45 render;
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
     code there.  The RK4 comparisons (2 tangents and 1) hold the
     kernel's planes on every PLAIN_SAMPLE-th ray against one plain
     tracking pass with 2 tangents on those rays (plain_tracking: its
     first 15 planes are the non-tracking plain version's), which phase
     9 reuses;
  3-4 (track). The tracking variants (shadow_softness 0.3, disk on: the
     crossing-opacity planes) against their plain versions at the 64x64
     parity cases, spin 0 and 0.9, RK4 (125 steps) and RKF45 (250), one
     plain
     tracking pass per case (phase 4's): RK4: K1-track under K1's exact
     contract plus the 7 tracking planes (track_stats), K2-track with 2
     tangents and with 1 under K2's, its primal codes equal to
     K1-track's; RKF45: the 15 shared planes under the non-tracking RKF45
     contracts (through the hard-edge colour and its tangents), the soft
     colour within SOFT_RKF45_FACTOR of the plain version's own response
     to a one-ulp change of the tolerance; the tracking planes live;
  9. the soft path at 1024x1024 (the bench scene with softness 0.3):
     render_image RK4 (prepass and render: K1-track launches counted),
     trace_rays_fast rays/s (median of 3), scene_value_and_grad RK4 and
     RKF45 (finite gradients, fwd+bwd rays/s median/min/max, K2-track
     launches counted); CUDA-event times and bounds of K1-track and
     K2-track (RK4, 2 tangents), each held to its plain version on every
     PLAIN_SAMPLE-th ray of the 1024x1024 pass (phase 8's plain tracking
     pass, whose primal must equal K1-track's plain version bitwise);
  10. gradient fidelity: torch.func.jvp of the clipped MSE through
     trace_rays_fast at 256x256, 800 steps, softness 0.3, against central
     finite differences at mass 1.03 and 0.98 (rtol FIDELITY_RTOL); the
     time and bound of its planes pass (K2-track with one tangent, K3's
     tracking variant);
  11. grad.inverse.fit_forward for 3 steps at 256x256 (RKF45 tol 1e-6,
     softness 0.3) from mass 1.03 against a target rendered at 1.0:
     finite losses and log_mass moving toward 0; ms per step;
  12. the kernels' anatomy (print_anatomy): every variant's block,
     resident blocks and warps per SM, registers and local memory (the
     libraries' attributes exports), divisions per step and the step
     loop's SASS mix (cuobjdump -sass of the built libraries); the lane
     and block shares of phases 7-9's 1024x1024 launches in raster and
     depth-sorted order; one `regime:` line per K1 launch of the main and
     soft paths (print_regimes): its time, the static issue ceiling of
     its step loop and the tail floor of its slowest warp;
  13. the XLA engine (render.trace.trace_rays, eager torch, one host
     synchronisation per step) on the card: trace_rays_fast(engine="xla")
     of the bench scene at 1024x1024 RK4 and 512x512 RKF45 against K1 on
     the same rays under the distribution contract, the result codes
     that differ and both engines' times (the XLA engine: its one gated
     pass; K1: median of 3 after a warm-up, min and max); LEAPFROG and
     YOSHIDA at the 64x64 parity case against
     the same call on the CPU under the RK4 contract;
  14. reverse mode against finite differences, float64 on the card:
     d(mean image)/d(mass) and d/d(spin) of grad.diff_trace.
     render_image_diff at 8x8, 150 steps, against central differences
     (eps 1e-6) within rtol 2e-3 (the JAX package's pin);
  15. the reverse half of the main path (bench.py's BENCH_GRAD=bucketed):
     grad.bucketed.grad_over_chunks over {mass, spin} of the bench loss
     at 1024x1024 RK4 in 16 chunks, its sizing pass one K1 launch
     (counted), timed by host clock: rays/s, the chunks' buckets, peak
     device memory, a finite gradient (gate), printed beside phase 8's
     forward-mode one; per-ray gradients over every SAMPLE_STRIDE-th ray
     (sample_grads: diff_trace with per-ray mass and spin leaves) on the
     card against the CPU's (gate: sample_stats, K2's per-ray contract
     on clipped d colour/d param over the rays whose code and step count
     agree, and their loss gradient within SAMPLE_GRAD_RTOL), which the
     CPU's with a planted fault (the trig slaving's transpose dropped)
     must fail;
  16. grad.inverse.fit: the JAX package's test case (16x16, 150 steps,
     float64, 25 Adam steps from mass 1.15 at rate 2e-2) halves the loss
     and keeps the frozen spin bit for bit, on the CPU; 2 steps at
     256x256 (float32) on the card, ms per step.
  17. the bh_* API, the particle simulator and the CLI on the card:
     (a) the five canonical rays of the CLI's tests (main.c's scene)
     through api.bh_trace_rays_batch (K1, launches counted) against the
     same call on a CPU context under the RK4 contract, and
     bh_trace_ray of ray 1 (the XLA engine) giving ray 1's code; (b) the
     bench frame's 1024x1024 rays through bh_trace_rays_batch on a
     context set to the bench scene by the setters, bit for bit phase
     7's trace_rays_fast Hit, rays/s (median of 3, min and max); (c) the
     particle simulator on PARTICLE_POOLS' two pools (the reference
     visualizer's 5,000 slots with 3,000 disk particles, and 2^20 slots
     seeded in the same proportions, with TEST particles inside 20 r_s),
     bh_update_particles steps timed (particles x steps / s, the
     geodesic and Newtonian shares), then one step from the same state
     on the card and on the CPU for every PARTICLE_SAMPLE-th slot
     (positions and velocities within rtol 1e-4, atol 1e-5, active
     masks equal, particles within one ulp of the capture radius on
     both sides listed and excluded); (d) `python -m
     blackhole_tpu_torch.cli tests` (its ray table equal to (a)'s) and
     `cli render` at 256x256 as two subprocesses started together, each
     timed from its start to its exit;
  18. the front ends on the card (viz.server, render.adaptive,
     viz.animate, cli view): (a) a served session at the reference
     window's 1280x720 (ViewerState spin 0.9, 400 steps, the default 32
     accumulation frames): `/` (the page), /state polled to full+8,
     `el =25` restarting the ladder at 1/32, `particles on` to full+2,
     /frame.png decoded, stop() and the render thread joined; gates: the
     first accumulation frame bit for bit trace_rays_fast of the same
     rays in raster order, the PNG decoding to the published frame's
     uint8, no stored error, K1 launched by every published frame; ms
     per frame by tier (min, median, max) split into trace, accumulate,
     particles, readback and PNG encode (CUDA events on the device
     part), requests answered, the time from the command to its first
     1/32 frame; (b) render_adaptive of the bench scene at 1024x1024
     (RK4, 1000 steps, base 1 + 4 extra samples on 1/8 of the pixels),
     its selection equal to the CPU's from the same edge map, and the
     first refinement pass on every ADAPTIVE_SAMPLE-th selected pixel, K1
     against its plain version under the RK4 contract; ms, launches,
     rays; (c) render_orbit_animation, 4 frames at 256x256, read back
     equal to their renders, the writer used (native or Python) and ms
     per frame; (d) `cli view --headless --frames 8` at 128x72, a
     subprocess started beside 17d's and waited for before (a), printing
     its stats line;
  19. the last slice on the card (phase19): (a) a world of one rank over
     NCCL in this process: render_image_sharded of the bench frame
     (kernel engine, depth-sorted) bit for bit phase 7's render_image,
     its ms (median of 3) and K1 launches; loss_and_grad_sharded of
     SHARDED_GRAD's case (bench_scaling's 256x256, 128 steps, budget 60)
     against the single-process image_loss backward within
     SHARDED_GRAD_TOL, both timed; (b) world2_job on 2 gloo ranks
     sharing the card (their collectives staged through the host): the
     gathered frame bit for bit (a)'s, one make_train_step_sharded step
     whose gradients are (a)'s within SHARDED_GRAD_TOL, the dry run's
     legs (entry.dryrun_legs, what dryrun_multichip(2) runs; its summary
     line), per-rank times; (c) export_trace of the bench scene with a
     symbolic ray count on the 1024x1024 rays against phase 7's
     trace_rays_fast under the RK4 colour contract (values differing
     bitwise counted, one K1 launch a call), export_render at 256x256
     the same and following a moved camera, export and call times; then
     (check_export_xla) the bench scene under LEAPFROG and YOSHIDA, whose
     artifacts hold the XLA engine's traced while_loop: one call each on
     the 1024x1024 rays against the live trace_rays_fast (colour max
     < 2e-4 over its non-MAX_STEPS rays, values differing bitwise
     counted, no K1 launch), export, call and live seconds; (d)
     the examples: render_kerr, lensed_starfield (512x512) and
     inverse_fit --method forward (K2) at their defaults in this
     process, inverse_fit --method reverse --fit-steps 2 and
     distributed_render at world 1 as subprocesses started after (a),
     each timed.
The CPU's shares of phases 15 and 16 (cpu_references) run in one
spawned worker process from the end of phase 2 on, beside the card's
phases, and phase 8's two plain K2 passes at the main path's shapes
(plain_main_shapes) in two more on the card, beside phases 3-6 (phase 7
waits for them, so no timing of phase 7 on overlaps them); the workers
are stopped before the script returns.
Every phase prints its start time.  The last three lines are the card,
one JSON object about the kernels and one JSON object with "ok" and the
device.  Exits non-zero without a result when no GPU is present or the
package is missing.
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
    "trace_planes[track]": dict(
        route="cuda", source="blackhole_tpu_torch/csrc/trace_kernel.cu",
        replaces="blackhole_tpu/render/pallas_kernel.py:597 (track=True)"),
    "trace_planes_fwdgrad[track]": dict(
        route="cuda", source="blackhole_tpu_torch/csrc/trace_fwdgrad.cu",
        replaces="blackhole_tpu/render/pallas_kernel.py:696 "
                 "(and :632 with one tangent; track=True)"),
}
# Floating-point operations per integration step (an FMA counts 2) of the
# kernels with the disk on, by (tangents, adaptive, track), K1 being 0
# tangents:
# (the least the arithmetic needs, what the CUDA source executes).  The
# source spends more on 1 / sqrt (two, where one rsqrt does), on a Dual
# quotient (a reciprocal of the divisor beside the primal's division) and
# on a Dual max/min (a weighted sum of the tangents, where a select does);
# it spends less where the tangent guard is the identity and skips its
# rescale, which the least counts all the same.  Both count only what the
# step runs: the crossing point on a crossing step, the radius in the
# plane for a tracking candidate, and in K1 not the previous point, which
# its state carries.  Counted by running csrc's
# source on a counting float over the parity camera's rays
# (tests/test_torch_step.py, test_flops_per_step_match_chip_smoke, holds
# these numbers).  The bound takes the least; the executed count gives the
# FP32 issue share.
FLOPS_PER_STEP = {
    (0, False, False): (731.1, 733.1), (0, True, False): (1433.1, 1435.1),
    (1, False, False): (2409.1, 2436.1), (1, True, False): (4577.5, 4678.5),
    (2, False, False): (4063.2, 4085.2), (2, True, False): (7694.2, 7843.0),
    (0, False, True): (736.9, 738.9), (0, True, True): (1437.6, 1439.6),
    (1, False, True): (2442.1, 2462.1), (1, True, True): (4606.6, 4700.6),
    (2, False, True): (4122.6, 4130.6), (2, True, True): (7747.1, 7882.0),
}
# IEEE float32 divisions (1 / sqrt included) and square roots (rsqrt
# included) per step of the same variants, by the same count
# (test_divisions_per_step_match_chip_smoke).  Without fast math a
# division is a reciprocal estimate, its refinement, a range check and a
# branch to a slow path on the card: about eight instructions.
DIVS_PER_STEP = {
    (0, False, False): (33.0, 4.0), (0, True, False): (53.02, 4.05),
    (1, False, False): (68.0, 5.0), (1, True, False): (110.07, 5.02),
    (2, False, False): (68.0, 5.0), (2, True, False): (111.07, 5.02),
    (0, False, True): (33.0, 4.83), (0, True, True): (53.02, 4.7),
    (1, False, True): (68.83, 5.83), (1, True, True): (110.73, 5.68),
    (2, False, True): (68.83, 5.83), (2, True, True): (111.73, 5.68),
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
# At 1024x1024 the plain versions integrate a sample of the kernel's
# pass (rays are independent): every PLAIN_SAMPLE-th ray for RK4 (one
# plain tracking pass with 2 tangents serves K2, K3, K1-track and
# K2-track), every RKF45_SAMPLE-th for K2 RKF45.  The plain versions'
# time is their per-step launches, nearly independent of the rays.
PLAIN_SAMPLE = 16
RKF45_SAMPLE = 64
# The one-step check (phase 5b): after 1 and 2 steps from the same
# states, a kernel's planes against its plain version's, each difference
# over (|plain| + the largest |plain| of its kind): the CPU twin's
# contract (tests/test_torch_step.py, test_dual_host_twin_matches_plain),
# a few ulp per operation.  The last chord direction's tangent takes the
# one-step tolerance of that slot in tests/test_torch_fwdgrad_step.py:
# it is the chord's tangent over its length, a cancellation of nearly
# parallel tangents this early (measured 1.4e-3 on the g++ twin without
# FMA, 3.2e-3 with it).  Once a step has used the RKF45 controller's
# output, FMA contraction moves the error estimate |y5 - y4|, a
# cancellation, and the controller carries that into h and its tangent:
# at the parity states every ray's first estimate is 1-2 ulp of its
# scale, so only the median is held there (g++ twin with FMA: median
# 8e-6, p99 0.15; with the controller's log tangent dropped, median
# 2-3e-3), and no first step there is rejected or clamped.  At the
# controller states (controller_scene) every first step is rejected with
# an estimate far above the tolerance: at the "clamped" states the rays
# whose second step a clamp set are held per ray (g++ twin with FMA:
# largest gap 9.8e-7 on 1,622 of 4,096 rays; with the scale clamp
# passing its input's tangent through, 0.23); at the "rejected" states,
# at tolerance 1e-4 so that the estimate is further from cancellation,
# the scale is clamped on 715 of 4,096 rays and the median holds the
# rejected branch's rule on the rest (g++ twin with FMA: median 3.7e-7;
# with the accepted branch's tangent on rejected steps, 1.3e-3).  K1 is held at the parity states only: it
# has no tangent.  By name: (camera distance and first step in M,
# tolerance).
ONE_STEP_TOL = 1e-4
ONE_STEP_CHORD_TOL = 1e-2
CONTROLLER_STATES = {"clamped": (5.0, 3.0, 1e-6),
                     "rejected": (8.0, 6.0, 1e-4)}
# Phases 4 and 3-4 (track) hold K2 and the tracking kernels to their
# plain versions at the RK4 parity cases over this many steps (phase 3
# holds K1, and the RKF45 cases hold K2, over the parity case's 250):
# the plain K2 costs ~120 ms a step on the card, and this cut keeps the
# script inside its time with the eager reverse phases (PERF.md).  At
# 125 steps the RKF45 cases break their contract's calibration (the
# controller's noise on rays in mid-flight), so they keep 250.
FWDGRAD_PARITY_STEPS = {"rk4": 125, "rkf45": 250}
# The soft boundary's AD/FD contract at 256x256, 800 steps (the JAX
# package's pin, tests/test_tpu_compiled.py).
FIDELITY_RTOL = 0.15
# RKF45 with tracking: the kernel's soft colour against the plain
# version's, in mean and p99, at most this times the plain version's own
# response to its tolerance moved by one ulp (check_track_vs_plain;
# PERF.md gives the measured ratios).
SOFT_RKF45_FACTOR = 2.0


def check(ok, what):
    """Every gate of the script: raise AssertionError(what) unless ok."""
    if not ok:
        raise AssertionError(what)


def parity_scene(spin, disk_enabled, integrator, device, size=64,
                 max_steps=250, softness=0.0):
    """The parity case of the JAX package's compiled-kernel checks
    (softness > 0 with the disk on: the tracking variants)."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    scene = Scene(
        BlackHole.create(1.0, spin, device=device),
        Disk.create(6.0, 20.0, device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                         max_steps=max_steps, integrator=integrator,
                         shadow_softness=softness, device=device),
        disk_enabled=disk_enabled,
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, device=device)
    o, d = cam.generate_rays(camera, size, size)
    return scene, camera, o.reshape(-1, 3), d.reshape(-1, 3)


def bench_scene(device, integrator="rk4", softness=0.0):
    """bench.py's scene: Kerr a=0.9, disk 6-20, 1000 steps, budget 150
    (softness > 0: the soft path)."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )

    scene = Scene(
        BlackHole.create(1.0, 0.9, device=device),
        Disk.create(6.0, 20.0, 1.0, 1.0, device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=150.0,
                         max_steps=1000, integrator=integrator,
                         tolerance=1e-6, shadow_softness=softness,
                         device=device),
    )
    camera = Camera.create(position=(0.0, -35.0, 12.0),
                           direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                           fov_deg=22.0, device=device)
    return scene, camera


def shade(planes, o, d, scene, L):
    """postprocess of K1's planes for the rays (o, d) (the capture margin
    too under shadow_softness > 0, as trace_rays_kernel passes it)."""
    from blackhole_tpu_torch.render import trace, trace_kernel as tk

    margin = (trace.compute_capture_margin(o, d, scene)
              if scene.config.shadow_softness > 0 else None)
    return tk.postprocess(planes, o.shape[0], (o.shape[0],), scene, None, L,
                          margin)


def kernel_and_plain(o, d, scene):
    """(kernel Hit, plain Hit) for the same rays: both go through
    trace_kernel.prepare and postprocess, the planes through K1's
    wrapper and through its plain version."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    scal, inp = tk.prepare(o, d, scene)
    args = tk.planes_args(scene)
    return [shade(p, o, d, scene, inp[5])
            for p in (tk.trace_planes(scal, inp, *args),
                      tk.trace_planes_plain(scal, inp, *args))]


def parity_stats(hit_k, hit_p, exact, gate=True):
    """The parity contract of kernel against plain; raises on a breach
    (gate=False: only reports).

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
    check(ok or not gate, f"kernel disagrees with plain: {stats}")
    return stats


# A ray whose plain colour itself moves by at least 1/ILL_RATIO of its
# kernel-vs-plain gap when one component of its direction moves by one
# ulp is ill-conditioned in float32: the kernel's rounding (FMA
# contraction, rsqrt) perturbs it by as much.  On the served tiers, whose
# time step is 8-20x coarser, such rays exist at 1/4000 (NVIDIA H100
# 80GB HBM3, 700 W: one ray of the 1/2 tier's 3,600, gap 7.7e-3 against
# a one-ulp move of 8.0e-3; one of the 1/8 tier's 900, 2.0e-4 against
# 1.5e-4).
ILL_RATIO = 4.0


def ulp_sensitivity(o, d, scene):
    """Per ray, the most its plain colour moves when one component of its
    direction moves by one ulp (up)."""
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    def plain(dd):
        scal, inp = tk.prepare(o, dd, scene)
        planes = tk.trace_planes_plain(scal, inp, *tk.planes_args(scene))
        return shade(planes, o, dd, scene, inp[5]).color

    base = plain(d)
    moves = []
    for comp in range(3):
        dd = d.clone()
        dd[:, comp] = torch.nextafter(dd[:, comp],
                                      torch.full_like(dd[:, comp], 1e30))
        moves.append((plain(dd) - base).abs().amax(-1))
    return torch.stack(moves).amax(0)


def conditioned_parity(o, d, scene):
    """The RK4 contract of K1 against its plain version on the rays (o, d),
    with ill-conditioned rays set apart: result codes equal on every ray;
    colour max < 2e-4 over the agreeing non-MAX_STEPS rays, apart from at
    most max(1, n / 500) rays whose gap is at most ILL_RATIO times their
    own one-ulp sensitivity (ulp_sensitivity).  Returns the stats."""
    from blackhole_tpu_torch.geom.types import RayResult

    hit_k, hit_p = kernel_and_plain(o, d, scene)
    stats = parity_stats(hit_k, hit_p, exact=True, gate=False)
    gap = (hit_k.color - hit_p.color).abs().amax(-1)
    over = ((gap >= 2e-4) & (hit_k.result == hit_p.result)
            & (hit_p.result != RayResult.MAX_STEPS)).nonzero().flatten()
    sens = ulp_sensitivity(o[over], d[over], scene)
    stats["rays_over_2e-4"] = [
        {"ray": int(i), "gap": float(gap[i]), "one_ulp": float(m)}
        for i, m in zip(over.tolist(), sens.tolist())]
    n = o.shape[0]
    check(stats["result_mismatch"] == 0
          and len(stats["rays_over_2e-4"]) <= max(1, n // 500)
          and bool((gap[over] <= ILL_RATIO * sens).all()),
          f"kernel disagrees with plain: {stats}")
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


def fwdgrad_trace(o, d, scene, tangents, plain=False):
    """trace_rays_kernel_fwdgrad's host stages around K2 (or its plain
    version): (hit, [hit tangent per direction])."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    planes_in, finish = tk.prepare_fwdgrad(o, d, scene, tangents)
    fn = tk.trace_planes_fwdgrad_plain if plain else tk.trace_planes_fwdgrad
    return finish(*fn(*planes_in, *tk.planes_args(scene)))


def grads_close(got, ref, rtol=1e-3, atol=1e-7):
    return all(abs(g - r) <= atol + rtol * abs(r) for g, r in zip(got, ref))


def fwdgrad_stats(kern, plain, exact, noise="steady", whole_rtol=None,
                  agree=None):
    """K2's contract against its plain version; kern and plain are
    (hit, [hit tangent]) of the same rays.  Raises on a breach of: the
    primal's parity contract (parity_stats); over the rays whose result
    code and step count agree (and, with the tracking planes, `agree`:
    whose tracked sample agrees, same_sample), the mean and p99 of each
    ray's largest
    difference of clipped colour tangent (TANGENT_LIMITS[noise]) and,
    unless noise is "controller", the loss gradient summed over them
    (rtol 1e-3, atol 1e-7); the whole loss gradient within whole_rtol
    (None: reported only)."""
    import torch

    (hit_k, dh_k), (hit_p, dh_p) = kern, plain
    stats = parity_stats(hit_k, hit_p, exact)
    same = (hit_k.result == hit_p.result) & (hit_k.steps == hit_p.steps)
    if agree is not None:
        same = same & agree
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


def soften(scene, softness=0.3):
    """The scene (or a scene tangent) with the soft boundary: with the
    disk on, its planes pass is the tracking variant."""
    return dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, shadow_softness=softness))


def plain_tracking(cases):
    """The plain version of K2-track (2 tangents) for the rays of the
    disk-on cases [(o, d, scene, tangents)], each scene made soft, in
    one pass over all their rays: the scene scalars go in per ray, which
    the plain version takes elementwise (the same result as a pass per
    case, bitwise: tests/test_torch_soft_slice.py).  Returns ([(out (22,
    n), douts (2, 22, n)) per case], CUDA-event ms).  The plain versions
    are bound by their per-step launches, not by rays, so one pass
    serves several comparisons: its first 15 planes (and their tangents)
    are the non-tracking plain K2's, its primal is the plain K1's
    (-track's), and its first direction the one-tangent result, bitwise
    (the tracking slots feed no other slot, and each direction is its
    own torch.func.jvp)."""
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    parts, sizes = [], []
    for o, d, scene, tangents in cases:
        soft = soften(scene)
        (scal, dscals, inp, dinps), _ = tk.prepare_fwdgrad(
            o, d, soft, [soften(t) for t in tangents])
        n = inp.shape[1]
        parts.append((scal[:, None].expand(-1, n),
                      dscals[:, :, None].expand(-1, -1, n), inp, dinps))
        sizes.append(n)
    scal, dscals, inp, dinps = (torch.cat(x, dim=-1) for x in zip(*parts))
    (out, douts), ms = _cuda_ms(lambda: tk.trace_planes_fwdgrad_plain(
        scal, dscals, inp, dinps, *tk.planes_args(soften(cases[0][2]))))
    return list(zip(out.split(sizes, -1), douts.split(sizes, -1))), ms


def shared(planes, k=2):
    """The (out, douts) view of a plain tracking pass for k tangents
    without the tracking planes."""
    return planes[0][:15], planes[1][:k, :15]


def check_fwdgrad_vs_plain(device, size=64, integrators=("rk4", "rkf45"),
                           plains=None):
    """Phase 4; returns one stats dict per case.  The disk-on cases of an
    integrator share one plain tracking pass (plain_tracking), kept in
    `plains` by (integrator, spin) for the tracking phase."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    out = []
    for integ in integrators:
        cases = []
        for spin, disk in ((0.0, True), (0.9, True), (0.9, False)):
            scene, _, o, d = parity_scene(
                spin, disk, integ, device, size,
                max_steps=FWDGRAD_PARITY_STEPS[integ])
            cases.append((spin, disk, o, d, scene, mass_spin_tangents(scene)))
        shared_planes, _ = plain_tracking([c[2:] for c in cases if c[1]])
        for spin, disk, o, d, scene, tangents in cases:
            kern = fwdgrad_trace(o, d, scene, tangents)
            if disk:
                planes = shared_planes.pop(0)
                if plains is not None:
                    plains[(integ, spin)] = planes
                _, finish = tk.prepare_fwdgrad(o, d, scene, tangents)
                plain = finish(*shared(planes))
            else:
                plain = fwdgrad_trace(o, d, scene, tangents, plain=True)
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
    # The plain version's directions are its one-tangent results, bitwise
    # (plain_tracking).
    ref = loss_grads(*fwdgrad_trace(o, d, scene, mass_spin_tangents(scene),
                                    plain=True), clip=None)[1]
    check(grads_close(got, ref), f"K3 jvp: gradient {got} vs plain {ref}")
    return {"dmass_kernel": got[0], "dmass_plain": ref[0],
            "dspin_kernel": got[1], "dspin_plain": ref[1],
            "k2_launches": launches}


def track_stats(planes_k, planes_p, o, d, scene, agree=500):
    """The 7 tracking planes of a tracking kernel's primal against its
    plain version's, for the rays (o, d) of the soft `scene`; raises on a
    breach.  agree (None: not gated): over the rays whose result code and
    step count agree, each ray's largest difference over the 7 planes
    (min_az far at 1e9 on both sides counts 0), at most n/agree rays
    differ by more than 1e-3: 500 at the exact contract's 64x64 cases, 50
    at 1024x1024, where FMA contraction moves near-critical rays' sampled
    points (K1-track: 0.75% of a sample, PERF.md; a strict < between two
    nearly equal sampled heights may also keep the other sample).  Live: some
    non-disk rays passed the disk's band above and
    below the plane, and setting min_az far (no crossing opacity) changes
    the colour of some rays."""
    from blackhole_tpu_torch.geom.types import RayResult

    n = planes_p.shape[1]
    same = (planes_k[0] == planes_p[0]) & (planes_k[2] == planes_p[2])
    diff = (planes_k[15:22] - planes_p[15:22]).abs().amax(0)[same]
    tracked = (planes_k[15] < 1e9) & (planes_k[0] != RayResult.DISK)
    blind = planes_k.clone()
    blind[15] = 1e9
    L = shade_L(o, d, scene)
    dc = (shade(planes_k, o, d, scene, L).color
          - shade(blind, o, d, scene, L).color).abs().amax(-1)
    stats = {
        "track_same_steps": int(same.sum()),
        "track_over_1e-3": int((diff > 1e-3).sum()),
        "track_max": float(diff.max()) if diff.numel() else 0.0,
        "tracked_above": int((tracked & (planes_k[18] > 0)).sum()),
        "tracked_below": int((tracked & (planes_k[18] < 0)).sum()),
        "opacity_rays": int((dc > 1e-3).sum()),
    }
    check((agree is None or stats["track_over_1e-3"] <= max(1, n // agree))
          and stats["tracked_above"] > 0 and stats["tracked_below"] > 0
          and stats["opacity_rays"] > 0,
          f"tracking planes disagree with plain or are not live: {stats}")
    return stats


def same_sample(planes_k, planes_p):
    """Rays whose 7 tracking planes agree within 1e-3: the same sample
    holds their closest approach to the disk plane (another sample moves
    the crossing opacity's tangent discontinuously, as another step count
    moves the others)."""
    return (planes_k[15:22] - planes_p[15:22]).abs().amax(0) <= 1e-3


def shade_L(o, d, scene):
    """The rays' conserved L, as prepare puts it in plane 5."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    return tk.prepare(o, d, scene)[1][5]


def hard_edge(scene):
    """The scene (or a scene tangent) with the hard shadow edge
    (softness 0): its finalize reads the 15 shared planes only."""
    return soften(scene, 0.0)


def soft_sensitivity(o, d, scene, plain_planes):
    """The soft colour's own response to the RKF45 step sequence: the
    plain tracking pass at the tolerance one float32 ulp higher against
    plain_planes (the same pass at the scene's tolerance), as
    parity_stats (reported, not gated)."""
    import numpy as np
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    tol = float(np.nextafter(np.float32(float(scene.config.tolerance)),
                             np.float32(1.0)))
    bumped = dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, tolerance=torch.tensor(tol, device=o.device)))
    scal, inp = tk.prepare(o, d, bumped)
    other = tk.trace_planes_plain(scal, inp, *tk.planes_args(bumped))
    L = inp[5]
    return parity_stats(shade(other, o, d, scene, L),
                        shade(plain_planes, o, d, scene, L), exact=False,
                        gate=False)


def check_track_vs_plain(device, size=64, integrators=("rk4", "rkf45"),
                         plains=None):
    """Phases 3-4 (track): K1-track, and K2-track with 2 tangents and with
    1, against their plain versions at the parity cases with softness 0.3
    and the disk on; returns one stats dict per kernel and case.

    One plain pass serves the three kernels of a case (plain_tracking;
    phase 4's, from `plains`, when given).  RK4: the non-tracking contracts
    (exact primal, K2's steady tangents) on the soft colour, plus the
    tracking planes (track_stats).  RKF45: another rounding is another
    step sequence, which samples the ray's closest approach to the disk
    plane at other points, and the crossing opacity shows that in the
    soft colour; the plain version at a tolerance one ulp higher moves it
    as much (PERF.md).  So the non-tracking RKF45 contracts hold the 15
    shared planes through the hard-edge colour and its tangents, the soft
    colour may differ from plain's by at most SOFT_RKF45_FACTOR times the
    plain version's own response to that ulp (soft_sensitivity, in mean
    and p99), and the tracking planes must be live; the tracking
    arithmetic is the same code as RK4's, held exactly there."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    out = []
    for integ in integrators:
        rkf45 = integ == "rkf45"
        for spin in (0.0, 0.9):
            scene, _, o, d = parity_scene(
                spin, True, integ, device, size,
                max_steps=FWDGRAD_PARITY_STEPS[integ], softness=0.3)
            args = tk.planes_args(scene)
            check(args[3], "the soft scene does not track")
            tangents = mass_spin_tangents(scene)
            planes_in, finish = tk.prepare_fwdgrad(o, d, scene, tangents)
            scal, dscals, inp, dinps = planes_in
            plain = (plains or {}).get((integ, spin))
            if plain is None:
                (plain,), _ = plain_tracking([(o, d, scene, tangents)])
            kerns = {
                "K1-track": tk.trace_planes(scal, inp, *args),
                "K2-track n=2": tk.trace_planes_fwdgrad(*planes_in, *args),
                "K2-track n=1": tk.trace_planes_fwdgrad(
                    scal, dscals[:1], inp, dinps[:1], *args),
            }
            case = {"integrator": integ, "spin": spin}
            base = soft_sensitivity(o, d, scene, plain[0]) if rkf45 else None
            for name, kern in kerns.items():
                k = 0 if name == "K1-track" else int(name[-1])
                prim = kern if k == 0 else kern[0]
                hit_k, hit_p = (shade(p, o, d, scene, inp[5])
                                for p in (prim, plain[0]))
                stats = parity_stats(hit_k, hit_p, exact=not rkf45,
                                     gate=not rkf45)
                if k:
                    fin = finish if k == 2 else tk.prepare_fwdgrad(
                        o, d, scene, tangents[:1])[1]
                    pair = (fin(*kern), fin(plain[0], plain[1][:k]))
                    if rkf45:
                        # The shared planes' tangents, through the hard
                        # edge; the soft gradient is reported.
                        fin_h = tk.prepare_fwdgrad(
                            o, d, hard_edge(scene),
                            [hard_edge(t) for t in tangents[:k]])[1]
                        hard = fwdgrad_stats(
                            fin_h(kern[0][:15], kern[1][:, :15]),
                            fin_h(plain[0][:15], plain[1][:k, :15]),
                            exact=False, noise="controller",
                            whole_rtol=RKF45_GRAD_RTOL)
                        stats.update({f"hard_{key}": v
                                      for key, v in hard.items()})
                        (_, g_k), (_, g_p) = (loss_grads(*h) for h in pair)
                        stats.update(soft_grad_kernel=g_k,
                                     soft_grad_plain=g_p)
                    else:
                        stats.update(fwdgrad_stats(
                            *pair, exact=True, whole_rtol=1e-3,
                            agree=same_sample(kern[0], plain[0])))
                    stats["codes_vs_k1"] = int(
                        (prim[0] != kerns["K1-track"][0]).sum())
                    check(stats["codes_vs_k1"] == 0,
                          f"{name}'s primal differs from K1-track's in "
                          f"{stats['codes_vs_k1']} result codes")
                if rkf45:
                    hard = parity_stats(
                        *(shade(p[:15], o, d, hard_edge(scene), inp[5])
                          for p in (prim, plain[0])), exact=False)
                    stats.update({f"hard_{key}": v for key, v in hard.items()})
                    stats.update(base_color_mean=base["color_mean"],
                                 base_color_p99=base["color_p99"])
                    check(stats["result_mismatch"] <= max(1, o.shape[0] // 500)
                          and stats["color_mean"]
                          <= SOFT_RKF45_FACTOR * base["color_mean"]
                          and stats["color_p99"]
                          <= SOFT_RKF45_FACTOR * base["color_p99"],
                          f"{name} soft colour beyond the plain version's "
                          f"own step-sequence response: {stats}")
                stats.update(track_stats(prim, plain[0], o, d, scene,
                                         agree=None if rkf45 else 500))
                out.append({"kernel": name, **case, **stats})
    return out


def one_step_gaps(kern, plain, track):
    """Per ray, the largest |kern - plain| / (|plain| + the largest
    |plain| of its kind) over the continuous planes, in the CPU twin's
    two kinds (tests/test_torch_step.py, test_dual_host_twin_matches_plain):
    lengths and positions (path length, hit position, r, min_r; with track
    min |z'| and its position) and unit directions and trig.  Returns
    (over every plane but the last chord direction, over that direction:
    lx, ly, lz and with track the direction at the tracked point); equal
    values, NaN on both sides included, count 0."""
    import torch

    lengths = [1, 3, 4, 5, 9, 14] + ([15, 16, 17, 18] if track else [])
    trig = [10, 11, 12, 13]
    chord = [6, 7, 8] + ([19, 20, 21] if track else [])

    def gaps(planes, kind):
        k, p = kern[planes].double(), plain[planes].double()
        scale = p.abs() + plain[kind].double().abs().nan_to_num(0.0).max()
        diff = (k - p).abs()
        same = (diff == 0) | (k.isnan() & p.isnan())
        return torch.where(same, 0.0, diff / scale).amax(0)

    return (torch.maximum(gaps(lengths, lengths), gaps(trig, trig + chord)),
            gaps(chord, trig + chord))


def controller_scene(device, size=64, track=False, states="clamped"):
    """The one-step check's controller states: the parity case's disk and
    scene (spin 0.9, RKF45) seen at fov 60 deg from closer, with a longer
    first step (CONTROLLER_STATES), so that every ray's first step is
    rejected with an error estimate far above the tolerance and far from
    cancellation.  "clamped": the controller clamps the step's scale at
    MIN_SCALE on many rays; "rejected": on fewer, so the rejected
    branch's rule sets most rays' second step."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    distance, first_step, tolerance = CONTROLLER_STATES[states]
    scene = Scene(
        BlackHole.create(1.0, 0.9, device=device),
        Disk.create(6.0, 20.0, device=device),
        SimConfig.create(time_step=first_step, max_ray_distance=80.0,
                         max_steps=250, integrator="rkf45",
                         tolerance=tolerance,
                         shadow_softness=0.3 if track else 0.0,
                         device=device),
        disk_enabled=True,
    )
    height = distance * 4.0 / 15.0  # the parity camera's elevation
    camera = Camera.create(position=(0.0, -distance, height),
                           direction=(0.0, distance, -height),
                           up=(0.0, 0.0, 1.0), fov_deg=60.0, device=device)
    o, d = cam.generate_rays(camera, size, size)
    return scene, o.reshape(-1, 3), d.reshape(-1, 3)


def clamped_rays(o, d, scene, args, plain, first):
    """The rays whose first RKF45 step was rejected and whose planes and
    tangents after the second step are bitwise the same with the
    tolerance halved and doubled: their second step's size was set by a
    clamp of the controller, not by its error estimate, so rounding
    cannot move it.  plain: the plain pass's (planes, tangents) after
    args' steps; first: its planes after one step."""
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    def same(a, b):
        return ((a == b) | (a.isnan() & b.isnan())).flatten(0, -2).all(0)

    out = (first[0] == -1.0) & (first[1] == 0.0)
    for f in (2.0, 0.5):
        s = dataclasses.replace(scene, config=dataclasses.replace(
            scene.config, tolerance=scene.config.tolerance * f))
        planes_in, _ = tk.prepare_fwdgrad(o, d, s, mass_spin_tangents(s))
        other = tk.trace_planes_fwdgrad_plain(*planes_in, *args)
        out &= same(other[0], plain[0]) & same(other[1], plain[1])
    return out


def check_one_step(device, size=64):
    """Phase 5b: K1 and K2 (2 tangents, d/d(mass, spin)) after 1 and 2
    steps from the same 64x64 parity states (spin 0.9), RK4 and RKF45,
    disk off, on, and on with tracking (softness 0.3), and K2 after 2
    steps from the two sets of controller states (controller_scene:
    RKF45, disk on, without and with tracking, for the controller's
    tangent rule), against their plain versions on the same inputs.
    Per ray the gap of a plane is |kernel - plain| / (|plain| + the
    largest |plain| of its kind) (one_step_gaps: the CPU twin's
    contract).  Gates: result codes and step counts equal; the median
    gap, primal and tangents, within ONE_STEP_TOL (a fault in a tangent
    rule moves most rays: at the "rejected" states a fault in the
    rejected branch's rule), the last chord direction's tangent within
    ONE_STEP_CHORD_TOL; the largest gaps within the same tolerances over
    every ray where no step has yet used the RKF45 controller's output
    (RK4, and the first RKF45 step), else over the rays whose second step
    a clamp of the controller set (clamped_rays).  The step size h is no
    output plane: the second step reads it, so its primal and its
    tangent (the RK4 schedule's and the controller's rule) show in the
    second step's chord, path length and position.  Returns one stats
    dict per case and step count."""
    import torch

    from blackhole_tpu_torch.render import trace_kernel as tk

    def q(x, p):
        return float(torch.quantile(x, p))

    cases = []
    for integ in ("rk4", "rkf45"):
        for disk, track in ((False, False), (True, False), (True, True)):
            scene, _, o, d = parity_scene(0.9, disk, integ, device, size,
                                          softness=0.3 if track else 0.0)
            cases.append(("parity", scene, o, d, (1, 2)))
    for states in CONTROLLER_STATES:
        for track in (False, True):
            cases.append((states, *controller_scene(device, size, track,
                                                    states), (2,)))
    out = []
    for states, scene, o, d, step_counts in cases:
        tangents = mass_spin_tangents(scene)
        planes_in, _ = tk.prepare_fwdgrad(o, d, scene, tangents)
        scal, _, inp, _ = planes_in
        disk_on, _, adaptive, track = tk.planes_args(scene)
        for steps in step_counts:
            args = (disk_on, steps, adaptive, track)
            k2, dk2 = tk.trace_planes_fwdgrad(*planes_in, *args)
            p2, dp2 = tk.trace_planes_fwdgrad_plain(*planes_in, *args)
            pairs, codes = [(k2, p2)], []
            if states == "parity":
                k1 = tk.trace_planes(scal, inp, *args)
                pairs.append((k1, tk.trace_planes_plain(scal, inp, *args)))
                codes = [(k2, k1)]
            prim = torch.stack([torch.maximum(*one_step_gaps(k, p, track))
                                for k, p in pairs]).amax(0)
            tan, chord = (torch.maximum(a, b) for a, b in zip(
                one_step_gaps(dk2[0], dp2[0], track),
                one_step_gaps(dk2[1], dp2[1], track)))
            if adaptive and steps > 1:
                first = tk.trace_planes_plain(scal, inp, disk_on, 1, adaptive,
                                              track)
                held = clamped_rays(o, d, scene, args, (p2, dp2), first)
            else:
                held = torch.ones_like(prim, dtype=torch.bool)

            def held_max(x):
                return float(x[held].max()) if bool(held.any()) else 0.0

            stats = {
                "states": states, "integrator": "rkf45" if adaptive else "rk4",
                "disk": disk_on, "track": track, "steps": steps,
                "codes_differ": sum(int((k[0] != p[0]).sum())
                                    for k, p in pairs + codes),
                "steps_differ": sum(int((k[2] != p[2]).sum())
                                    for k, p in pairs),
                "advanced": int((p2[1] > 0).sum()),
                "primal_max": float(prim.max()),
                "primal_p50": q(prim, 0.5), "primal_p99": q(prim, 0.99),
                "tangent_max": float(tan.max()),
                "tangent_p50": q(tan, 0.5), "tangent_p99": q(tan, 0.99),
                "chord_max": float(chord.max()),
                "chord_p50": q(chord, 0.5), "chord_p99": q(chord, 0.99),
                "rays_over_tol": int((torch.maximum(prim, tan)
                                      > ONE_STEP_TOL).sum()),
                "held_rays": int(held.sum()),
                "held_max": max(held_max(prim), held_max(tan)),
                "held_chord_max": held_max(chord),
            }
            stats["ok"] = (
                stats["codes_differ"] == stats["steps_differ"] == 0
                and stats["advanced"] > 0
                and max(stats["primal_p50"], stats["tangent_p50"])
                <= ONE_STEP_TOL
                and stats["chord_p50"] <= ONE_STEP_CHORD_TOL
                and stats["held_max"] <= ONE_STEP_TOL
                and stats["held_chord_max"] <= ONE_STEP_CHORD_TOL)
            out.append(stats)
    held = sum(st["held_rays"] for st in out if st["states"] == "clamped")
    check(held > 0, "one-step check: no clamped state's step was clamped")
    bad = [st for st in out if not st["ok"]]
    check(not bad, f"one-step check: kernel and plain disagree: {bad}")
    return out


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


def _kernel_ms(fn, repeats=3):
    """(result of an untimed first call, median milliseconds of `repeats`
    more calls timed with _cuda_ms).  Each timed call's output is dropped
    before the next, so the caching allocator hands its block back and
    no device allocation (which waits on the host) falls between the
    events."""
    res = fn()
    return res, statistics.median(_cuda_ms(fn)[1] for _ in range(repeats))


def bound_ms(n_tan, adaptive, steps_plane, n_rays, track=False):
    """The least time the card could take for a planes pass: the larger
    of its operations (the least per-step count times this run's steps)
    over the FP32 rate and its bytes (inputs read once, outputs written
    once) over the memory rate.  Returns (ms, "operations" or "bytes",
    the executed operations' time in ms at the FP32 rate)."""
    steps = float(steps_plane.double().sum())
    least, executed = (c * steps for c in
                       FLOPS_PER_STEP[(n_tan, adaptive, track)])
    n_planes = 15 + 7 * int(track)
    nbytes = 4 * ((1 + n_tan) * (12 + 16 * n_rays)
                  + (1 + n_tan) * n_planes * n_rays)
    t_ops, t_bytes = least / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * executed / FP32_FLOPS)


def print_bound(what, ms, bound):
    b_ms, by, issue_ms = bound
    print(f"{what} bound: {b_ms:.3f} ms ({by}), {100 * b_ms / ms:.1f}% of it "
          f"reached; FP32 issue of the executed operations "
          f"{100 * issue_ms / ms:.1f}%")


def time_k1_launches(camera, scene, scene45):
    """K1's other launches on the forward half (phase 7): render_image's
    depth-order prepasses (1024 / 8 = 128x128 RK4 and 512 / 8 = 64x64
    RKF45, raster order) and its 512x512 RKF45 render (depth order):
    CUDA-event ms, median of 3, and bounds."""
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel as tk

    for what, sc, size, depth in (("prepass 128^2 rk4", scene, 128, False),
                                  ("prepass 64^2 rkf45", scene45, 64, False),
                                  ("render 512^2 rkf45", scene45, 512, True)):
        o, d = cam.generate_rays(camera, size, size)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        if depth:
            order = image.predicted_depth_order(sc, camera, size, size)
            o, d = o[order], d[order]
        scal, inp = tk.prepare(o, d, sc)
        args = tk.planes_args(sc)
        planes, ms = _kernel_ms(lambda: tk.trace_planes(scal, inp, *args))
        print(f"K1 {what}: kernel {ms:.3f} ms")
        print_bound(f"K1 {what}", ms,
                    bound_ms(0, args[2], planes[2], o.shape[0]))


def sample_hits(o, d, scene, tangents, planes, pick):
    """K2's planes (out, douts) for the rays pick of (o, d), finished
    into (hit, [hit tangent]) with scene's host stages."""
    from blackhole_tpu_torch.render import trace_kernel

    _, finish = trace_kernel.prepare_fwdgrad(o[pick], d[pick], scene,
                                             tangents)
    return finish(*planes)


def time_fwdgrad(o, d, scene, tangents):
    """K2's planes for all rays (median of 3 CUDA-event times)."""
    from blackhole_tpu_torch.render import trace_kernel

    planes_in, _ = trace_kernel.prepare_fwdgrad(o, d, scene, tangents)
    args = trace_kernel.planes_args(scene)
    return _kernel_ms(lambda: trace_kernel.trace_planes_fwdgrad(
        *planes_in, *args))


def plain_main_shapes(integrator):
    """The plain K2 passes phase 8 holds K2 to at the main path's shapes,
    run in a worker process on the card beside phases 3-6 (the plain
    versions are bound by their per-step launches, so the two passes and
    those phases' plain passes overlap): "rk4", the plain tracking pass
    (plain_tracking, 2 tangents) on every PLAIN_SAMPLE-th ray of the
    bench frame; "rkf45", the plain K2 on every RKF45_SAMPLE-th ray of
    its RKF45 variant.  The inputs are made here as phase 8 makes them
    (the same calls on the same card give the same bits).  Returns the
    planes on the host and their CUDA-event ms."""
    import torch

    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import trace_kernel as tk

    dev = torch.device("cuda", 0)
    scene, camera = bench_scene(dev, integrator)
    o, d = cam.generate_rays(camera, 1024, 1024)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tangents = mass_spin_tangents(scene)
    if integrator == "rk4":
        pick = slice(None, None, PLAIN_SAMPLE)
        (planes,), ms = plain_tracking([(o[pick], d[pick], scene, tangents)])
    else:
        pick = slice(None, None, RKF45_SAMPLE)
        (scal, dscals, inp, dinps), _ = tk.prepare_fwdgrad(o, d, scene,
                                                           tangents)
        planes, ms = _cuda_ms(lambda: tk.trace_planes_fwdgrad_plain(
            scal, dscals, inp[:, pick].contiguous(),
            dinps[:, :, pick].contiguous(), *tk.planes_args(scene)))
    return tuple(t.cpu() for t in planes), ms


def check_fwdgrad_main_shapes(o, d, scene, scene45, k1_planes, k1_ms,
                              plains):
    """Phase 8's K2 checks at the main path's shapes, given K1's planes
    and time for the same rays of `scene` and plain_main_shapes' passes
    {integrator: (planes, ms)} on the card; prints times and bounds and
    returns K2's row of the kernels line, the plain tracking pass on
    every PLAIN_SAMPLE-th ray (with its ms), which phase 9 reuses, and
    K2's step-count planes {name: steps} (RK4 and RKF45, raster)."""
    n = o.shape[0]
    tangents = mass_spin_tangents(scene)
    pick = slice(None, None, PLAIN_SAMPLE)
    # K2 against its plain version at the main path's shapes (raster
    # order: the depth order changes no value, phase 6), the plain
    # version on every PLAIN_SAMPLE-th ray: one tracking pass serves K2
    # with 2 tangents and with 1 here and the tracking kernels in
    # phase 9 (plain_tracking).
    plain_s = plains["rk4"]
    k2_planes, ms_k2 = time_fwdgrad(o, d, scene, tangents)
    k2_bound = bound_ms(2, False, k2_planes[0][2], n)
    out_k = k2_planes[0]
    k2_vs_k1 = int((out_k[0] != k1_planes[0]).sum())
    print(f"K2 primal vs K1 1024^2 rk4: {k2_vs_k1} of {n} result codes "
          f"differ, {int((out_k != k1_planes).sum())} of {k1_planes.numel()} "
          f"plane values")
    print(f"K2 planes 1024^2 rk4 (2 tangents): kernel {ms_k2:.3f} ms "
          f"({ms_k2 / k1_ms:.2f}x K1); plain (tracking, 2 tangents) on every "
          f"{PLAIN_SAMPLE}th ray {plain_s[1]:.3f} ms (in a worker beside "
          f"phases 3-6)")
    print_bound("K2 1024^2 rk4", ms_k2, k2_bound)
    big2 = fwdgrad_stats(
        sample_hits(o, d, scene, tangents,
                    (out_k[:, pick], k2_planes[1][:, :, pick]), pick),
        sample_hits(o, d, scene, tangents, shared(plain_s[0]), pick),
        exact=False)
    print(f"parity K2 1024^2 rk4 (every {PLAIN_SAMPLE}th ray): "
          f"{json.dumps(big2)}")
    # K3: the same kernel with one tangent (d/dmass).
    k3_planes, ms_k3 = time_fwdgrad(o, d, scene, tangents[:1])
    print(f"K3 (K2, 1 tangent) planes 1024^2 rk4: kernel {ms_k3:.3f} ms "
          f"({ms_k3 / k1_ms:.2f}x K1)")
    print_bound("K3 1024^2 rk4", ms_k3, bound_ms(1, False, k3_planes[0][2], n))
    big3 = fwdgrad_stats(
        sample_hits(o, d, scene, tangents[:1],
                    (k3_planes[0][:, pick], k3_planes[1][:, :, pick]), pick),
        sample_hits(o, d, scene, tangents[:1], shared(plain_s[0], 1), pick),
        exact=False)
    print(f"parity K3 1024^2 rk4 (every {PLAIN_SAMPLE}th ray): "
          f"{json.dumps(big3)}")
    # RKF45: the kernel on all rays, the plain version on a sample.
    tangents45 = mass_spin_tangents(scene45)
    k45_planes, ms_k45 = time_fwdgrad(o, d, scene45, tangents45)
    pick45 = slice(None, None, RKF45_SAMPLE)
    p45, ms_p45 = plains["rkf45"]
    print(f"K2 planes 1024^2 rkf45 (2 tangents): kernel {ms_k45:.3f} ms; "
          f"plain on every {RKF45_SAMPLE}th ray {ms_p45:.3f} ms (in a "
          f"worker beside phases 3-6)")
    print_bound("K2 1024^2 rkf45", ms_k45,
                bound_ms(2, True, k45_planes[0][2], n))
    big45 = fwdgrad_stats(
        sample_hits(o, d, scene45, tangents45,
                    (k45_planes[0][:, pick45], k45_planes[1][:, :, pick45]),
                    pick45),
        sample_hits(o, d, scene45, tangents45, p45, pick45),
        exact=False, noise="controller", whole_rtol=RKF45_GRAD_RTOL)
    print(f"parity K2 1024^2 rkf45 (every {RKF45_SAMPLE}th ray): "
          f"{json.dumps(big45)}")
    row = {"max_abs_err": max(
        max(b["color_max"], b["tangent_max"]) for b in (big2, big3, big45)),
        "ms": ms_k2, "plain_ms": plain_s[1], "plain_every": PLAIN_SAMPLE,
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None}
    return row, plain_s, {"K2 n=2 rk4": out_k[2],
                          "K2 n=2 rkf45": k45_planes[0][2]}


def _sync():
    """Wait for the card (nothing to wait for on a CPU rehearsal)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(fn, repeats=3, warmup=True):
    """Wall seconds of fn() to a synchronise: one warm-up (unless
    warmup=False), then repeats."""
    times = []
    for _ in range(int(warmup) + repeats):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        times.append(time.perf_counter() - t0)
    return res, times[int(warmup):]


def loss_of_hit(h):
    """The bench loss: sum(colour) / 3n."""
    return h.color.sum() / h.color.numel()


def fwdbwd(base, camera, o, d):
    """bench.py's fwd+bwd: scene_value_and_grad over {mass, spin} of the
    bench loss with the depth order, at base's mass and spin, for the
    square image's rays (o, d) of camera."""
    from blackhole_tpu_torch.grad import fast_grad
    from blackhole_tpu_torch.render import image

    def scene_fn(p):
        return dataclasses.replace(base, blackhole=dataclasses.replace(
            base.blackhole, mass=p["mass"], spin=p["spin"]))

    params = {"mass": base.blackhole.mass.clone(),
              "spin": base.blackhole.spin.clone()}
    vg = fast_grad.scene_value_and_grad(loss_of_hit, scene_fn)
    size = math.isqrt(o.shape[0])
    order = image.predicted_depth_order(scene_fn(params), camera, size, size)
    return vg(params, o, d, order=order)


def time_fwdbwd(name, base, camera, o, d):
    _, times = _timed(lambda: fwdbwd(base, camera, o, d))
    n = o.shape[0]
    print(f"fwd+bwd {name} {math.isqrt(n)}^2 (2 tangents, depth order): "
          f"{n / statistics.median(times):.1f} rays/s median of 3 "
          f"(min {n / max(times):.1f}, max {n / min(times):.1f}; "
          f"{[round(t, 4) for t in times]} s)")


def check_gradients(grad_runs):
    for name, (loss, grads) in grad_runs.items():
        g = [float(grads["mass"]), float(grads["spin"])]
        check(all(math.isfinite(x) for x in g),
              f"{name} gradients are not finite: {g}")
        print(f"gradient {name}: loss {float(loss):.9f} "
              f"d/dmass {g[0]:.9e} d/dspin {g[1]:.9e}")


def soft_path(dev, camera, o, d, plain_s):
    """Phase 9: the soft path (the bench scene with softness 0.3) for the
    square image's rays (o, d) of camera, 1024x1024 in main; the tracking
    kernels are held to plain_s, phase 8's plain tracking pass (and its
    ms) on every PLAIN_SAMPLE-th ray.  Returns the kernels line's two
    tracking rows and the tracking kernels' RK4 step-count planes {name:
    steps} (raster)."""
    import torch

    from blackhole_tpu_torch.render import image, trace_kernel as tk

    scene, _ = bench_scene(dev, softness=0.3)
    scene45, _ = bench_scene(dev, "rkf45", softness=0.3)
    n = o.shape[0]
    size = math.isqrt(n)
    tk.launches = tk.fwdgrad_launches = 0
    tk.track_launches = tk.fwdgrad_track_launches = 0
    t0 = time.perf_counter()
    img = image.render_image(scene, camera, size, size)
    grad_runs = {name: fwdbwd(base, camera, o, d)
                 for name, base in (("rk4", scene), ("rkf45", scene45))}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"k1": tk.launches, "k1_track": tk.track_launches,
                "k2": tk.fwdgrad_launches, "k2_track": tk.fwdgrad_track_launches}
    print(f"soft path: render_image {size}^2 rk4 + scene_value_and_grad "
          f"{size}^2 rk4 + rkf45 in {main_s:.3f} s, launches {launches}")
    check(launches["k1_track"] >= 1 and launches["k2_track"] >= 1
          and launches["k1"] == launches["k1_track"]
          and launches["k2"] == launches["k2_track"],
          f"the soft path did not run only the tracking kernels: {launches}")
    check(img.shape == (size, size, 3) and bool(torch.isfinite(img).all()),
          f"the soft image is not finite {size}^2 RGB")
    print(f"soft image rk4: mean {float(img.mean()):.6f}")
    check_gradients({f"soft {k} {size}^2": v for k, v in grad_runs.items()})
    _, times = _timed(lambda: image.trace_rays_fast(o, d, scene))
    print(f"trace_rays_fast soft {size}^2 rk4: "
          f"{n / statistics.median(times):.1f} rays/s "
          f"(median of 3: {[round(t, 4) for t in times]} s)")
    for name, base in (("soft rk4", scene), ("soft rkf45", scene45)):
        time_fwdbwd(name, base, camera, o, d)

    # K1-track and K2-track (RK4, 2 tangents): times, bounds, and the
    # plain tracking pass of phase 8 on every PLAIN_SAMPLE-th ray.
    plain_planes, ms_p = plain_s
    pick = slice(None, None, PLAIN_SAMPLE)
    scal, inp = tk.prepare(o, d, scene)
    args = tk.planes_args(scene)
    planes_k, ms_k = _kernel_ms(lambda: tk.trace_planes(scal, inp, *args))
    sample_k = planes_k[:, pick]
    # K1-track's own plain version on the sample, timed; it equals the
    # shared pass's primal bitwise (plain_tracking).
    plain1, ms_p1 = _cuda_ms(lambda: tk.trace_planes_plain(
        scal, inp[:, pick].contiguous(), *args))
    same = bool(((plain1 == plain_planes[0])
                 | (plain1.isnan() & plain_planes[0].isnan())).all())
    check(same, "the plain tracking pass's primal is not the plain K1-track's")
    hits = [shade(p, o[pick], d[pick], scene, inp[5][pick])
            for p in (sample_k, plain_planes[0])]
    k1s = parity_stats(*hits, exact=False)
    k1s.update(track_stats(sample_k, plain_planes[0], o[pick], d[pick],
                           scene, agree=50))
    k1_bound = bound_ms(0, False, planes_k[2], n, track=True)
    print(f"K1-track planes {size}^2 rk4: kernel {ms_k:.3f} ms; plain on every "
          f"{PLAIN_SAMPLE}th ray {ms_p1:.3f} ms")
    print_bound(f"K1-track {size}^2 rk4", ms_k, k1_bound)
    print(f"parity K1-track {size}^2 rk4 (every {PLAIN_SAMPLE}th ray): "
          f"{json.dumps(k1s)}")
    tangents = mass_spin_tangents(scene)
    k2_planes, ms_k2 = time_fwdgrad(o, d, scene, tangents)
    k2s = fwdgrad_stats(
        sample_hits(o, d, scene, tangents,
                    (k2_planes[0][:, pick], k2_planes[1][:, :, pick]), pick),
        sample_hits(o, d, scene, tangents, plain_planes, pick), exact=False,
        agree=same_sample(k2_planes[0][:, pick], plain_planes[0]))
    k2s.update(track_stats(k2_planes[0][:, pick], plain_planes[0], o[pick],
                           d[pick], scene, agree=50))
    k2_bound = bound_ms(2, False, k2_planes[0][2], n, track=True)
    print(f"K2-track planes {size}^2 rk4 (2 tangents): kernel {ms_k2:.3f} ms "
          f"({ms_k2 / ms_k:.2f}x K1-track); plain on every {PLAIN_SAMPLE}th "
          f"ray {ms_p:.3f} ms (phase 8's pass)")
    print_bound(f"K2-track {size}^2 rk4", ms_k2, k2_bound)
    print(f"parity K2-track {size}^2 rk4 (every {PLAIN_SAMPLE}th ray): "
          f"{json.dumps(k2s)}")
    # RKF45: the tracking kernels' times and bounds (their plain versions
    # are held at 64x64, phases 3-4).
    scal45, inp45 = tk.prepare(o, d, scene45)
    args45 = tk.planes_args(scene45)
    planes45, ms45 = _kernel_ms(
        lambda: tk.trace_planes(scal45, inp45, *args45))
    print(f"K1-track planes {size}^2 rkf45: kernel {ms45:.3f} ms")
    print_bound(f"K1-track {size}^2 rkf45", ms45,
                bound_ms(0, True, planes45[2], n, track=True))
    k245_planes, ms245 = time_fwdgrad(o, d, scene45,
                                      mass_spin_tangents(scene45))
    print(f"K2-track planes {size}^2 rkf45 (2 tangents): kernel "
          f"{ms245:.3f} ms ({ms245 / ms45:.2f}x K1-track)")
    print_bound(f"K2-track {size}^2 rkf45", ms245,
                bound_ms(2, True, k245_planes[0][2], n, track=True))
    rows = []
    for name, ms, plain_ms, bound, err, n_launch in (
            ("trace_planes[track]", ms_k, ms_p1, k1_bound, k1s["color_max"],
             launches["k1_track"]),
            ("trace_planes_fwdgrad[track]", ms_k2, ms_p, k2_bound,
             max(k2s["color_max"], k2s["tangent_max"]),
             launches["k2_track"])):
        rows.append({"name": name, **KERNELS[name], "launches": n_launch,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "plain_every": PLAIN_SAMPLE, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": None})
    return rows, {"K1-track rk4": planes_k[2],
                  "K2-track n=2 rk4": k2_planes[0][2]}


def check_fidelity(dev, size=256, steps=800, softness=0.3):
    """Phase 10: d(MSE)/d(mass) by torch.func.jvp through trace_rays_fast
    (K2-track with one tangent) against central finite differences, at
    mass 1.03 and 0.98 (the JAX package's TPU pin)."""
    import torch

    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.grad import fast_grad
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    camera = Camera.create(position=(0.0, -35.0, 12.0),
                           direction=(0.0, 35.0, -12.0), up=(0.0, 0.0, 1.0),
                           fov_deg=22.0, device=dev)
    o, d = cam.generate_rays(camera, size, size)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    base = Scene(BlackHole.create(1.0, 0.9, device=dev),
                 Disk.create(6.0, 20.0, device=dev),
                 SimConfig.create(time_step=0.1, max_ray_distance=150.0,
                                  max_steps=steps, shadow_softness=softness,
                                  device=dev),
                 disk_enabled=True)

    def render(mass):
        s = dataclasses.replace(base, blackhole=dataclasses.replace(
            base.blackhole, mass=mass))
        return fast_grad.clip_color_tangent(
            image.trace_rays_fast(o, d, s)).color

    target = render(torch.tensor(1.0, device=dev))

    def loss(mass):
        return 0.5 * torch.mean((render(mass) - target) ** 2)

    out = {}
    # K3-track: the planes pass with one tangent (d/dmass) that each jvp
    # below launches, at mass 1.03.
    from blackhole_tpu_torch.render import trace_kernel as tk

    s = dataclasses.replace(base, blackhole=dataclasses.replace(
        base.blackhole, mass=torch.tensor(1.03, device=dev)))
    k3_planes, ms = time_fwdgrad(o, d, s, mass_spin_tangents(s)[:1])
    print(f"K3-track planes {size}^2 {steps} steps rk4 (1 tangent): kernel "
          f"{ms:.3f} ms")
    print_bound(f"K3-track {size}^2", ms,
                bound_ms(1, False, k3_planes[0][2], o.shape[0], track=True))
    check(tk.planes_args(s)[3], "the fidelity scene does not track")
    for m0, eps in ((1.03, 3e-3), (0.98, 3e-3)):
        m = torch.tensor(m0, device=dev)
        _, ad = torch.func.jvp(loss, (m,), (torch.ones_like(m),))
        fd = (float(loss(m + eps)) - float(loss(m - eps))) / (2 * eps)
        out[f"m0={m0}"] = {"ad": float(ad), "fd": fd,
                           "ad_over_fd": float(ad) / fd}
        check(abs(float(ad) - fd) <= FIDELITY_RTOL * abs(fd),
              f"AD/FD fidelity at mass {m0}: {out}")
    return out


def check_fit(dev, size=256, steps=3, learning_rate=1e-2):
    """Phase 11: fit_forward (RKF45 tol 1e-6, softness 0.3) from mass
    1.03 to a target rendered at 1.0; |log_mass| must shrink at every
    step (the gradient's sign is right) and the losses be finite."""
    import torch

    from blackhole_tpu_torch.grad import inverse
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    target_scene, camera = bench_scene(dev, "rkf45", softness=0.3)
    o, d = cam.generate_rays(camera, size, size)
    target = image.trace_rays_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                   target_scene).color.reshape(size, size, 3)
    init = dataclasses.replace(target_scene, blackhole=dataclasses.replace(
        target_scene.blackhole, mass=torch.tensor(1.03, device=dev)))
    log_mass = [math.log(1.03)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, _, losses = inverse.fit_forward(
        target, init, camera, size, size, steps=steps,
        learning_rate=learning_rate,
        callback=lambda i, p, loss: log_mass.append(float(p["log_mass"])))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    out = {"losses": losses, "log_mass": log_mass, "ms_per_step": ms,
           "mass": float(scene.blackhole.mass)}
    check(all(math.isfinite(x) for x in losses), f"fit losses: {out}")
    check(all(abs(b) < abs(a) for a, b in zip(log_mass, log_mass[1:])),
          f"fit_forward did not move log_mass toward 0: {out}")
    return out


def _ms_stats(times):
    """"median (min-max) ms" of a list of seconds."""
    ms = sorted(1e3 * t for t in times)
    return f"{statistics.median(ms):.3f} ms ({ms[0]:.3f}-{ms[-1]:.3f})"


def check_xla_engine(dev, camera, scene, scene45):
    """Phase 13: the XLA engine (trace.trace_rays, eager torch) on the
    card against K1 on the same rays: the bench scene at 1024x1024 RK4
    and 512x512 RKF45 under the distribution contract (parity_stats),
    each engine timed by host clock after a synchronise (the XLA engine:
    its one gated pass, which has no compile to warm; K1: median of 3
    after a warm-up, min and max); then LEAPFROG and YOSHIDA, which only
    the XLA engine runs, at the 64x64 parity case on the card against the
    same call on the CPU under the RK4 contract."""
    import torch

    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    out = []
    for name, sc, size in (("rk4", scene, 1024), ("rkf45", scene45, 512)):
        o, d = cam.generate_rays(camera, size, size)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        hit_x, t_x = _timed(lambda: image.trace_rays_fast(o, d, sc,
                                                          engine="xla"),
                            repeats=1, warmup=False)
        hit_k, t_k = _timed(lambda: image.trace_rays_fast(o, d, sc))
        stats = parity_stats(hit_x, hit_k, exact=False)
        n = o.shape[0]
        print(f"xla engine {name} {size}^2: {stats['result_mismatch']} of "
              f"{n} result codes differ from K1's; xla "
              f"{_ms_stats(t_x)}, K1 path {_ms_stats(t_k)}; "
              f"{n / statistics.median(t_x):.1f} rays/s (xla)")
        out.append({"integrator": name, "size": size, **stats,
                    "xla_ms": 1e3 * statistics.median(t_x),
                    "kernel_path_ms": 1e3 * statistics.median(t_k)})
    for integ in ("leapfrog", "yoshida"):
        hits = []
        for device in (dev, torch.device("cpu")):
            sc, _, o, d = parity_scene(0.9, True, integ, device)
            hits.append(image.trace_rays_fast(o, d, sc).map(
                lambda x: x.cpu()))
        stats = parity_stats(hits[0], hits[1], exact=True)
        check(bool((hits[0].steps == hits[1].steps).all()),
              f"{integ}: step counts differ between the card and the CPU")
        out.append({"integrator": integ, "size": 64, "vs": "cpu", **stats})
    return out


def small_diff_scene(device, dtype, spin=0.5, max_steps=150):
    """The JAX package's gradient tests' scene and camera
    (tests/test_grad.py: spin 0.5, disk 6-20, 150 steps of 0.1, camera
    (0, -30, 8), fov 25 deg)."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )

    kw = dict(device=device, dtype=dtype)
    scene = Scene(BlackHole.create(1.0, spin, **kw),
                  Disk.create(6.0, 20.0, **kw),
                  SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                                   max_steps=max_steps, **kw),
                  disk_enabled=True)
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, **kw)
    return scene, camera


def check_reverse_fd(dev, size=8, eps=1e-6, rtol=2e-3):
    """Phase 14: d(mean image)/d(mass) and d/d(spin) of render_image_diff
    by one .backward(), float64 on the card, against central finite
    differences (the JAX package's pin, tests/test_grad.py)."""
    import torch

    from blackhole_tpu_torch.grad import diff_trace

    scene, camera = small_diff_scene(dev, torch.float64)

    def loss(mass, spin):
        bh = dataclasses.replace(scene.blackhole, mass=mass, spin=spin)
        return diff_trace.render_image_diff(
            dataclasses.replace(scene, blackhole=bh), camera, size,
            size).mean()

    v0 = {"mass": 1.0, "spin": 0.5}
    vs = {k: torch.tensor(v, dtype=torch.float64, device=dev,
                          requires_grad=True) for k, v in v0.items()}
    loss(**vs).backward()
    out = {}
    for k in v0:
        with torch.no_grad():
            fd = [float(loss(**{**vs, k: vs[k] + sgn * eps}))
                  for sgn in (1.0, -1.0)]
        fd = (fd[0] - fd[1]) / (2 * eps)
        ad = float(vs[k].grad)
        out[k] = {"ad": ad, "fd": fd, "rel": abs(ad - fd) / abs(fd)}
        check(math.isfinite(ad) and abs(ad - fd) <= rtol * abs(fd),
              f"reverse mode against FD, d/d{k}: {out}")
    return out


def bench_grad(scene, o, d):
    """bench.py's BENCH_GRAD=bucketed: grad_over_chunks over {mass, spin}
    of the bench loss sum(colour) / 3n, the rays in 16 chunks."""
    from blackhole_tpu_torch.grad import bucketed

    n3 = 3 * o.shape[0]

    def scene_fn(p):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"], spin=p["spin"]))

    params = {"mass": scene.blackhole.mass.clone(),
              "spin": scene.blackhole.spin.clone()}
    return bucketed.grad_over_chunks(scene_fn, params, o, d,
                                     lambda c, i: c.sum() / n3, chunks=16)


# Phase 15: the card's reverse-mode gradients of the bench loss, ray by
# ray, over every SAMPLE_STRIDE-th ray of the 1024x1024 image, against
# the CPU's (sample_stats).  A near-critical ray's gradient is chaotic:
# one ray whose step count differs by 3 between the card and the CPU
# carries d colour/d mass -83,541 on one and -22,330 on the other, which
# moves the sample's whole gradient 13-fold (NVIDIA H100 80GB HBM3, 700 W).  So, as
# K2's contract does with forward tangents, the gate holds each ray's
# d colour/d param clipped at TANGENT_CLIP, over the rays whose result
# code and step count agree: per ray in mean and p99 within
# TANGENT_LIMITS["steady"] (measured 1.8e-4 and 7.5e-4 at most), and
# their loss gradient within SAMPLE_GRAD_RTOL (measured 4.7e-4; with the
# trig slaving's transpose dropped 0.22).
SAMPLE_STRIDE = 256
SAMPLE_GRAD_RTOL = 2e-3


def sample_rays():
    """Every SAMPLE_STRIDE-th ray of the bench camera's 1024x1024 image,
    made on the CPU (the card's copy of them is bitwise the same)."""
    from blackhole_tpu_torch.render import camera as cam

    import torch

    _, camera = bench_scene(torch.device("cpu"))
    o, d = cam.generate_rays(camera, 1024, 1024)
    return (o.reshape(-1, 3)[::SAMPLE_STRIDE].contiguous(),
            d.reshape(-1, 3)[::SAMPLE_STRIDE].contiguous())


def sample_grads(dev):
    """Per ray of sample_rays(), on dev: its d sum(colour)/d(mass, spin)
    (3n times the bench loss's per-ray gradient) by reverse mode through
    diff_trace.trace_rays_diff with the mass and the spin as per-ray
    leaves, and its result code and step count; all on the CPU."""
    import torch

    from blackhole_tpu_torch.grad import diff_trace

    scene, _ = bench_scene(dev)
    o, d = (x.to(dev) for x in sample_rays())
    n = o.shape[0]
    leaves = {k: getattr(scene.blackhole, k).detach().expand(n).clone()
              .requires_grad_(True) for k in ("mass", "spin")}
    s = dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, **leaves))
    hit = diff_trace.trace_rays_diff(o, d, s)
    grads = torch.autograd.grad(hit.color.sum(), list(leaves.values()))
    return {"result": hit.result.cpu(), "steps": hit.steps.cpu(),
            **{k: g.double().cpu() for k, g in zip(leaves, grads)}}


def sample_stats(got, ref, gate=True):
    """The phase-15 contract of per-ray gradients `got` against `ref`
    (sample_grads, as tensors or arrays); raises on a breach (gate=False:
    only reports)."""
    import torch

    got, ref = ({k: torch.as_tensor(v) for k, v in x.items()}
                for x in (got, ref))
    agree = (got["result"] == ref["result"]) & (got["steps"] == ref["steps"])
    n = agree.numel()
    stats = {"n_rays": n, "codes_differ": int((got["result"]
                                               != ref["result"]).sum()),
             "steps_differ": int((got["steps"] != ref["steps"]).sum())}
    gaps = []
    for k in ("mass", "spin"):
        a, b = (x[k].clamp(-TANGENT_CLIP, TANGENT_CLIP)[agree]
                for x in (got, ref))
        dif = (a - b).abs()
        stats[f"{k}_mean"] = float(dif.mean())
        stats[f"{k}_p99"] = float(dif.quantile(0.99))
        stats[f"{k}_grad"] = [float(a.sum()) / (3 * n), float(b.sum()) / (3 * n)]
        gaps.append(abs(float(a.sum() - b.sum())) / abs(float(b.sum())))
        stats[f"{k}_whole"] = [float(got[k].sum()) / (3 * n),
                               float(ref[k].sum()) / (3 * n)]
    stats["grad_rel_err"] = max(gaps)
    mean, p99 = TANGENT_LIMITS["steady"]
    stats["ok"] = (max(stats["mass_mean"], stats["spin_mean"]) < mean
                   and max(stats["mass_p99"], stats["spin_p99"]) < p99
                   and stats["grad_rel_err"] <= SAMPLE_GRAD_RTOL)
    check(stats["ok"] or not gate,
          f"card and CPU reverse-mode gradients differ: {stats}")
    return stats


def fit_case(dev, dtype, size, steps, learning_rate, start_mass):
    """inverse.fit of log_mass alone from start_mass toward a target
    rendered at mass 1 (small_diff_scene): (losses, fitted mass, seconds,
    whether spin_raw stayed bit for bit at every step)."""
    import torch

    from blackhole_tpu_torch.grad import diff_trace, inverse

    scene, camera = small_diff_scene(dev, dtype)
    target = diff_trace.render_image_diff(scene, camera, size, size).detach()
    bad = dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=torch.tensor(start_mass, dtype=dtype,
                                           device=dev)))
    spin_raw = inverse.pack_params(bad, camera)["spin_raw"]
    frozen = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, _, losses = inverse.fit(
        target, bad, camera, size, size, steps=steps,
        learning_rate=learning_rate, optimize=("log_mass",),
        callback=lambda i, p, loss: frozen.append(
            torch.equal(p["spin_raw"].detach(), spin_raw)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (losses, float(fitted.blackhole.mass), time.perf_counter() - t0,
            all(frozen))


def cpu_references(threads=3):
    """The CPU's share of phases 15 and 16, run in a subprocess beside
    the card's phases: sample_grads on the CPU, the same with the trig
    slaving's transpose dropped (a planted fault; this process ends
    after), and inverse.fit on the JAX package's test case
    (tests/test_grad.py: 16x16, 150 steps, float64, 25 Adam steps from
    mass 1.15 at rate 2e-2).  That fit's 256 rays leave the card idle
    (3,750 eager steps cost ~4 min there, host-bound); phase 16 times
    the fit on the card at 256x256 instead."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(threads)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    grads = sample_grads(cpu)
    sample_s = time.perf_counter() - t0
    losses, mass, fit_s, frozen = fit_case(cpu, torch.float64, 16, 25, 2e-2,
                                           1.15)
    # Last, the planted fault: the trig slaving's transpose dropped.
    from blackhole_tpu_torch.render import trace

    trace._SlaveTrig.backward = staticmethod(lambda ctx, *g: (None,) * 6)
    def arrays(g):
        return {k: v.numpy() for k, v in g.items()}

    return {"sample": arrays(grads), "sample_s": sample_s,
            "planted": arrays(sample_grads(cpu)), "fit": {
                "losses_first_last": [losses[0], losses[-1]], "mass": mass,
                "spin_frozen": frozen, "seconds": fit_s}}


def check_reverse_path(dev, scene, o, d, k1_ms, fwd_grads, cpu_ref):
    """Phase 15: the reverse half of the main path at 1024x1024 (16
    chunks, each at its bucket of the step ladder, sized by one K1 pass;
    chunks that share a bucket go through one pass). Gates: K1 launched
    by the sizing pass, the gradient finite, and the card's per-ray
    gradients over sample_rays() against the CPU's under sample_stats'
    contract (cpu_ref() returns cpu_references' result); the CPU's with
    the trig slaving's transpose dropped must fail that contract (a
    planted fault).  fwd_grads:
    phase 8's forward-mode gradient of the same loss, printed beside it
    (clipped colour tangents: another estimator)."""
    import torch

    from blackhole_tpu_torch.grad import bucketed
    from blackhole_tpu_torch.render import trace_kernel

    n = o.shape[0]
    trace_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss, grads = bench_grad(scene, o, d)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = trace_kernel.launches
    peak = torch.cuda.max_memory_allocated(dev)
    g = {k: float(v) for k, v in grads.items()}
    check(launches >= 1, "grad_over_chunks' sizing pass launched no K1")
    check(all(math.isfinite(x) for x in g.values()),
          f"grad_over_chunks gradient is not finite: {g}")
    need = bucketed._chunk_steps(o.view(16, -1, 3), d.view(16, -1, 3),
                                 scene).tolist()
    ladder = bucketed._buckets_for(scene.config.max_steps)
    buckets = [next((b for b in ladder if s + 1 <= b), ladder[-1])
               for s in need]
    print(f"grad_over_chunks 1024^2 rk4 (16 chunks): {secs:.3f} s, "
          f"{n / secs:.1f} rays/s; K1 launches {launches} (the sizing "
          f"launch: K1 1024^2 rk4 {k1_ms:.3f} ms, phase 7); buckets "
          f"{buckets} (steps {need}); peak memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"gradient grad_over_chunks 1024^2: loss {float(loss):.9f} "
          f"d/dmass {g['mass']:.9e} d/dspin {g['spin']:.9e}; forward mode "
          f"(phase 8, clipped tangents) d/dmass {fwd_grads[0]:.9e} d/dspin "
          f"{fwd_grads[1]:.9e}")

    t0 = time.perf_counter()
    card = sample_grads(dev)
    card_s = time.perf_counter() - t0
    ref = cpu_ref()
    stats = sample_stats(card, ref["sample"], gate=False)
    print(f"per-ray gradients, every {SAMPLE_STRIDE}th ray, card ({card_s:.1f}"
          f" s) against CPU ({ref['sample_s']:.1f} s): {json.dumps(stats)}")
    planted = sample_stats(ref["planted"], card, gate=False)
    print(f"planted fault (the slave-trig transpose dropped, on the CPU) "
          f"against the card: {json.dumps(planted)}")
    sample_stats(card, ref["sample"])
    check(not planted["ok"],
          "the sample gate passes with the slave-trig transpose dropped")
    return {"seconds": secs, "rays_per_s": n / secs, "launches": launches,
            "peak_bytes": peak, "grad": g, "sample": stats,
            "planted": planted}


def check_reverse_fit(dev, cpu_ref, size=256, steps=2):
    """Phase 16: grad.inverse.fit.  The JAX package's test case (from
    cpu_references, run on the CPU) must halve its loss and keep the
    frozen spin bit for bit; on the card, `steps` Adam steps at size x
    size (float32, 150 steps, from mass 1.03), ms per step."""
    import torch

    fit = cpu_ref()["fit"]
    check(fit["losses_first_last"][1] < 0.5 * fit["losses_first_last"][0],
          f"fit did not halve the loss: {fit}")
    check(abs(fit["mass"] - 1.0) < 0.15, f"fit moved mass away: {fit}")
    check(fit["spin_frozen"], f"fit moved the frozen spin: {fit}")
    losses, mass, secs, frozen = fit_case(dev, torch.float32, size, steps,
                                          1e-2, 1.03)
    out = {"jax_test_case_cpu": fit, f"ms_per_step_{size}":
           1e3 * secs / steps, f"losses_{size}": losses, "mass": mass}
    check(all(math.isfinite(x) for x in losses) and frozen,
          f"fit at {size}^2: {out}")
    return out


# The API path (phase 17).  The particle pools: the reference
# visualizer's deployment (5,000 slots, 3,000 disk particles, SURVEY.md
# 3.4 and section 4's table) and a pool of 2^20 slots seeded in the same
# proportions, each with its number of bh_update_particles steps.
PARTICLE_POOLS = ((5000, 100), (1 << 20, 20))
PARTICLE_SAMPLE = 64  # the card-against-CPU step holds every 64th slot


def api_context(device, bench=False):
    """A bh_* context on device, configured by the setters as the CLI's
    tests command does (main.c's scene), or as the bench scene (Kerr
    a=0.9, disk 6-20, step 0.1, path 150, 1000 steps, tol 1e-6)."""
    from blackhole_tpu_torch import api, cli

    context = api.bh_initialize(device=device)
    if not bench:
        cli.configure_tests(context)
        return context
    for rc in (api.bh_configure_black_hole(context, 1.0, 0.9),
               api.bh_configure_accretion_disk(context, 6.0, 20.0, 1.0, 1.0),
               api.bh_configure_simulation(context, 0.1, 150.0, 1000, 1e-6)):
        check(rc == api.BHError.SUCCESS, f"a bh_configure_* setter "
              f"returned {rc}")
    return context


def check_api_rays(dev):
    """Phase 17a: the five canonical rays through bh_trace_rays_batch on
    the card (K1, launches counted) against the same call on a CPU
    context (the plain version) under the RK4 contract, and
    bh_trace_ray (the XLA engine) of ray 1 giving ray 1's code.
    Returns (the card's Hit on the CPU, stats)."""
    from blackhole_tpu_torch import api, cli
    from blackhole_tpu_torch.render import trace_kernel

    o = [r[0] for r in cli.TEST_RAYS]
    d = [r[1] for r in cli.TEST_RAYS]
    context = api_context(dev)
    before = trace_kernel.launches
    hit = api.bh_trace_rays_batch(context, o, d).map(lambda x: x.cpu())
    launched = trace_kernel.launches - before
    check(launched >= 1, "bh_trace_rays_batch launched no K1")
    ref = api.bh_trace_rays_batch(api_context("cpu"), o, d)
    stats = parity_stats(hit, ref, exact=True)
    one = api.bh_trace_ray(context, o[0], d[0])
    check(int(one.result) == int(hit.result[0]),
          f"bh_trace_ray gave {int(one.result)}, the batch "
          f"{int(hit.result[0])}")
    return hit, {"launches": launched, "results": hit.result.tolist(),
                 "steps": hit.steps.tolist(), **stats}


def check_api_frame(dev, o, d, ref_hit):
    """Phase 17b: bh_trace_rays_batch of the rays (o, d) through a
    context set to the bench scene by the setters, timed (_timed: one
    warm-up, median of 3), its Hit bit for bit ref_hit (trace_rays_fast
    of the same rays and scene scalars)."""
    from blackhole_tpu_torch import api
    from blackhole_tpu_torch.render import trace_kernel

    context = api_context(dev, bench=True)
    before = trace_kernel.launches
    hit, times = _timed(lambda: api.bh_trace_rays_batch(context, o, d))
    launched = trace_kernel.launches - before
    mism = _hits_equal(hit, ref_hit)
    check(launched >= 1 and mism == 0, f"bh_trace_rays_batch: {launched} "
          f"K1 launches, {mism} values differ from trace_rays_fast's")
    n = o.shape[0]
    return {"n_rays": n, "launches": launched, "elementwise_mismatch": mism,
            "rays_per_s_median": n / statistics.median(times),
            "rays_per_s_min": n / max(times),
            "rays_per_s_max": n / min(times)}


def seed_pool(context, capacity, generator):
    """A pool seeded as the reference visualizer seeds its own: 3/5 of
    the slots disk particles (bh_create_accretion_disk_particles), 1/5
    TEST particles on perturbed circular orbits at 6-38 M (inside 20 r_s,
    so the geodesic branch runs; one bulk insert), 1/5 free."""
    import torch

    from blackhole_tpu_torch import api
    from blackhole_tpu_torch.particles import system as psys

    n_disk, n_test = 3 * capacity // 5, capacity // 5
    system = api.bh_create_particle_system(context, capacity)
    system, made = api.bh_create_accretion_disk_particles(context, system,
                                                          n_disk)
    check(made == n_disk, f"{made} of {n_disk} disk particles seeded")
    u = torch.rand((n_test, 4), generator=generator,
                   device=context.device)
    r = 6.0 + 32.0 * u[:, 0]
    phi = 2.0 * math.pi * u[:, 1]
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                       4.0 * (u[:, 2] - 0.5)], dim=-1)
    v = torch.sqrt(context.blackhole.mass / r) * (0.9 + 0.2 * u[:, 3])
    vel = torch.stack([-torch.sin(phi) * v, torch.cos(phi) * v,
                       torch.zeros_like(v)], dim=-1)
    system, ids = psys.add_particles_batch(system, pos, vel, 0.0,
                                           psys.ParticleType.TEST)
    check(bool((ids >= 0).all()), "the test particles did not fit")
    return system


def _pool_rows(system, rows):
    """The pool of the slots `rows` (count and next_id kept)."""
    return system.replace(**{
        f.name: getattr(system, f.name)[rows]
        for f in dataclasses.fields(system)
        if getattr(system, f.name).dim()})


def step_card_vs_cpu(system, context, cpu_context, stride=PARTICLE_SAMPLE):
    """One bh_update_particles step from the same state on the card and,
    for every stride-th slot, on the CPU: positions and velocities within
    rtol 1e-4, atol 1e-5 and active masks equal, except for particles the
    step leaves within one ulp of the capture radius r_s on both sides
    (listed)."""
    import torch
    from torch.utils import _pytree as pytree

    from blackhole_tpu_torch import api

    rows = slice(None, None, stride)
    card = _pool_rows(api.bh_update_particles(context, system), rows)
    card = pytree.tree_map(lambda x: x.cpu(), card)
    cpu = api.bh_update_particles(cpu_context, pytree.tree_map(
        lambda x: x.cpu(), _pool_rows(system, rows)))
    close = [torch.isclose(getattr(card, k), getattr(cpu, k), rtol=1e-4,
                           atol=1e-5, equal_nan=True).all(-1)
             for k in ("position", "velocity")]
    same_active = card.active == cpu.active
    rs = 2.0 * cpu_context.blackhole.mass
    ulp = torch.nextafter(rs, torch.tensor(math.inf)) - rs
    edge = ~same_active & torch.stack([
        (torch.linalg.vector_norm(p.position, dim=-1) - rs).abs() <= ulp
        for p in (card, cpu)]).all(0)
    bad = ~(close[0] & close[1]) | (~same_active & ~edge)
    gap = (card.position - cpu.position).abs().nan_to_num(0.0)
    check(not bool(bad.any()), f"particle step card against CPU: slots "
          f"{(torch.nonzero(bad)[:, 0] * stride).tolist()[:20]} differ, "
          f"position gap max {float(gap.max()):.3e}")
    return {"sample": int(cpu.active.numel()),
            "position_gap_max": float(gap.max()),
            "capture_edge_excluded": (torch.nonzero(edge)[:, 0]
                                      * stride).tolist()}


def check_particles(dev):
    """Phase 17c: each PARTICLE_POOLS pool seeded on the card (seed_pool)
    and stepped by bh_update_particles, timed by host clock to a
    synchronise: particles x steps / s and each regime's share; then
    step_card_vs_cpu from the final state."""
    import torch

    from blackhole_tpu_torch import api
    from blackhole_tpu_torch.particles import dynamics

    out = []
    cpu_context = api_context("cpu", bench=True)
    for capacity, steps in PARTICLE_POOLS:
        context = api_context(dev, bench=True)
        system = seed_pool(context, capacity,
                           torch.Generator(device=dev).manual_seed(2))
        active0 = int(system.num_active())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            system = api.bh_update_particles(context, system)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        geo = dynamics.regimes(system, context.blackhole) & system.active
        n_active = int(system.num_active())
        pos = system.position[system.active]
        check(bool(torch.isfinite(pos).all()),
              f"pool {capacity}: an active particle is not finite")
        out.append({
            "capacity": capacity, "steps": steps, "active_start": active0,
            "active_end": n_active, "seconds": seconds,
            "particle_steps_per_s": active0 * steps / seconds,
            "geodesic_share": int(geo.sum()) / n_active,
            "newtonian_share": 1.0 - int(geo.sum()) / n_active,
            **step_card_vs_cpu(system, context, cpu_context)})
    return out


def _python_m(module, *args):
    """Start python -m <module> with args from the checkout's root;
    returns (process, start time)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def _cli(*args):
    """Start python -m blackhole_tpu_torch.cli with args (_python_m)."""
    return _python_m("blackhole_tpu_torch.cli", *args)


def _cli_done(proc, t0, timeout=600):
    """(stdout, wall seconds since t0) of a _python_m process; fails
    unless it exits 0."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"{' '.join(proc.args[2:])} exited "
          f"{proc.returncode}: {err[-2000:]}")
    return out, time.perf_counter() - t0


def check_cli(api_hits):
    """Phase 17d: `cli tests` and `cli render` (256x256) as two
    subprocesses on the card, started together, each timed from its
    start to its exit (start-up and the cached kernels' load included);
    the tests' ray table equal to the one api_hits (phase 17a) prints,
    the render a 256x256 PNG."""
    import contextlib
    import io

    from blackhole_tpu_torch import cli
    from blackhole_tpu_torch.viz import io as viz_io

    out = "build/chip_smoke_render.png"
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / out).unlink(missing_ok=True)
    procs = []
    try:
        procs.append(_cli("tests"))
        procs.append(_cli("render", "--width", "256", "--height", "256",
                          "--out", out))
        (tests, t_tests), (_, t_render) = (_cli_done(*p) for p in procs)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        cli.print_ray_table(api_hits)
    check(table.getvalue() in tests,
          "cli tests' ray table differs from bh_trace_rays_batch's")
    img = viz_io.read_image(str(ROOT / out))
    check(img.shape == (256, 256, 3) and float(img.max()) > 0.0,
          f"cli render wrote {img.shape}, max {float(img.max())}")
    return {"tests_s": t_tests, "render_s": t_render,
            "render_mean": float(img.mean())}


# Phase 18: the front ends on the card.  The served session runs the
# reference window's 1280x720 on the bench black hole (Kerr a=0.9) at
# the viewer's 400 steps; the adaptive render the bench scene at 1024^2.
SERVED = dict(width=1280, height=720, steps=400, spin=0.9)
ADAPTIVE_SAMPLE = 64  # the plain version traces every 64th refined ray
SERVED_SAMPLE = 64  # ... and every 64th ray of a served frame or tier


def _http(port, path, data=None):
    """(status, body) of one request to the server on localhost."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _tier_at_least(tier, label):
    """Whether the served tier has reached `label` (full+n: n or more)."""
    if not tier.startswith("full+"):
        return False
    return int(tier[5:]) >= int(label[5:])


def _poll_state(port, done, answered, timeout=300.0):
    """Poll /state until done(state); returns that state."""
    deadline = time.perf_counter() + timeout
    while True:
        status, body = _http(port, "/state")
        answered.append(status)
        state = json.loads(body)
        if done(state):
            return state
        check(time.perf_counter() < deadline and "render error" not in
              state["status"], f"/state stuck at {state}")
        time.sleep(0.01)


def _split(records):
    """{stage: (min, median, max) ms} over timing records."""
    out = {}
    for key in ("frame_ms", "trace_ms", "accumulate_ms", "particles_ms",
                "readback_ms", "encode_ms"):
        vals = sorted(r[key] for r in records if key in r)
        if vals:
            out[key] = (round(vals[0], 3), round(statistics.median(vals), 3),
                        round(vals[-1], 3))
    return out


def check_served_session(dev, width=SERVED["width"], height=SERVED["height"],
                         steps=SERVED["steps"]):
    """Phase 18a: viz.server.serve(port=0, block=False) at width x height
    with ViewerState(spin 0.9, steps) on dev, driven over HTTP: `/`
    (JAX's page), /state polled to full+8, `el =25` restarting the
    ladder at 1/32, `particles on` to full+2, /frame.png decoded, then
    stop() and the render thread joined.  Gates: the first accumulation
    frame (jitter 0) bit for bit trace_rays_fast of the same rays in
    raster order; K1 against its plain version on the served rays
    (served_k1); the PNG decoding to the published frame's uint8
    (clip(255 x), truncated); no stored error; every published frame
    launched K1.  Returns (stats, K1 launches)."""
    import collections

    import numpy as np
    import torch

    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel
    from blackhole_tpu_torch.utils import profiling
    from blackhole_tpu_torch.viz import io as viz_io
    from blackhole_tpu_torch.viz import server, viewer

    frames = {"launches": [], "recent": collections.deque(maxlen=8)}
    publish = server.RenderServer._publish

    def record(self, frame, tier, *args):
        # The K1 launches since the previous publish: the frame's own.
        launched = trace_kernel.launches - sum(frames["launches"])
        if tier == "full+1" and "first_full" not in frames:
            frames["first_full"] = frame.clone()
        seq = publish(self, frame, tier, *args)
        frames["launches"].append(launched)
        frames["recent"].append((self._png, frame.clone()))
        return seq

    answered = []
    state = viewer.ViewerState(spin=SERVED["spin"], steps=steps, device=dev)
    server.RenderServer._publish = record
    profiling.synchronize()
    trace_kernel.launches = 0
    t0 = time.perf_counter()
    httpd = None
    try:
        httpd, rt = server.serve(port=0, state=state, width=width,
                                 height=height, block=False)
        rs, port = httpd.render_server, httpd.server_address[1]
        status, page = _http(port, "/")
        answered.append(status)
        check(page == server._PAGE.encode(), "/ is not the page")
        _poll_state(port, lambda s: _tier_at_least(s["tier"], "full+8"),
                    answered)
        t_full8 = time.perf_counter() - t0
        t_cmd = time.perf_counter()
        seq_before = rs.frame()[1]
        status, body = _http(port, "/cmd", b"el =25")
        answered.append(status)
        check(json.loads(body)["action"] == "changed", f"el =25: {body}")
        seq_cmd = rs.frame()[1]

        def restarts():
            # Published frames of the restarted ladder's first tier: a
            # small frame can be replaced before a poll of /state sees it.
            return [r for r in rs.frame_timings()
                    if r["seq"] > seq_before and r["tier"] == "1/32"]

        _poll_state(port, lambda s: s["seq"] > seq_before and restarts(),
                    answered)
        restart = restarts()[0]
        check(restart["seq"] <= seq_cmd + 2, f"the ladder restarted at seq "
              f"{restart['seq']}, {seq_cmd} when the command returned")
        status, body = _http(port, "/cmd", b"particles on")
        answered.append(status)
        check(json.loads(body)["action"] == "changed", f"particles: {body}")
        seq_p = rs.frame()[1]
        _poll_state(port, lambda s: s["seq"] > seq_p and s["particles"]
                    and _tier_at_least(s["tier"], "full+2"), answered)
        status, png = _http(port, "/frame.png")
        answered.append(status)
    finally:
        if httpd is not None:
            httpd.render_server.stop()
            httpd.render_thread.join(timeout=120)
            httpd.shutdown()
            httpd.server_close()
        server.RenderServer._publish = publish
    check(not rt.is_alive(), "the render thread did not stop")
    check(rs.error is None, f"the render thread failed: {rs.error!r}")
    launches = trace_kernel.launches
    timings = rs.frame_timings()
    check(len(frames["launches"]) == len(timings) and
          min(frames["launches"]) >= 1, f"K1 launches per served frame: "
          f"{frames['launches']}")
    # The published frame's uint8, as the JAX server makes it.
    frame = next(f for p, f in frames["recent"] if p == png)
    u8 = np.clip(frame.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    path = ROOT / "build" / "chip_smoke_served.png"
    path.parent.mkdir(exist_ok=True)
    path.write_bytes(png)
    decoded = np.round(viz_io.read_image(str(path)) * 255.0).astype(np.uint8)
    check(np.array_equal(decoded, u8), "/frame.png does not decode to the "
          "published frame's uint8")
    # The first accumulation frame against trace_rays_fast, raster order.
    ref_state = viewer.ViewerState(spin=SERVED["spin"], steps=steps,
                                   device=dev)
    ox, oy = cam.jitter_offsets(0, 32)
    o, d = cam.generate_rays(ref_state.camera(), width, height, ox, oy)
    ref = image.trace_rays_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                ref_state.scene()).color
    got = frames["first_full"]
    check(torch.equal(got, ref.reshape(height, width, 3)),
          f"the first accumulation frame differs from trace_rays_fast in "
          f"{int((got != ref.reshape(height, width, 3)).sum())} values")
    parity, k1 = served_k1(ref_state, o.reshape(-1, 3), d.reshape(-1, 3),
                           width, height)
    by_tier = collections.defaultdict(list)
    for r in timings:
        by_tier["full" if r["tier"].startswith("full") else r["tier"]].append(r)
    stats = {
        "size": [width, height], "steps": steps, "frames": len(timings),
        "requests_answered": len(answered),
        "requests_ok": sum(s == 200 for s in answered),
        "to_full+8_s": t_full8,
        "cmd_to_1/32_ms": 1e3 * (restart["t"] - t_cmd),
        "png_bytes": len(png),
        "ms_by_tier (min, median, max)": {k: _split(v)
                                          for k, v in by_tier.items()},
        "particles_frames": sum("particles_ms" in r for r in timings),
        "k1_alone_full_frame": k1,
        "k1_vs_plain (RK4 contract)": parity,
    }
    full_trace = stats["ms_by_tier (min, median, max)"]["full"]["trace_ms"][1]
    k1["share_of_median_full_trace"] = k1["ms"] / full_trace
    return stats, launches


def served_k1(state, o, d, width, height):
    """K1 on the served path's rays, after the session (these launches
    are not counted): every SERVED_SAMPLE-th ray of the jitter-0 full
    frame (o, d: raster order, the state's step budget) and of the 1/2
    tier (tier_scene: 50 steps, the time step 8x coarser at 400), and
    the whole 1/32 tier (20 steps, 20x coarser), each against the plain
    version under the RK4 contract with ill-conditioned rays set apart
    (conditioned_parity); and K1 alone on the whole full
    frame, CUDA-event ms (median of 3) beside its bound.  Returns
    ({case: parity stats}, K1 timing)."""
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import trace_kernel as tk
    from blackhole_tpu_torch.viz import animate

    scene, camera = state.scene(), state.camera()
    cases = [("full", scene, o[::SERVED_SAMPLE], d[::SERVED_SAMPLE])]
    for divisor, steps, stride in ((2, 50, SERVED_SAMPLE), (32, 20, 1)):
        to, td = cam.generate_rays(camera, max(8, width // divisor),
                                   max(8, height // divisor))
        cases.append((f"1/{divisor}", animate.tier_scene(scene, steps),
                      to.reshape(-1, 3)[::stride],
                      td.reshape(-1, 3)[::stride]))
    parity = {name: {"max_steps": sc.config.max_steps,
                     **conditioned_parity(so, sd, sc)}
              for name, sc, so, sd in cases}
    scal, inp = tk.prepare(o, d, scene)
    args = tk.planes_args(scene)
    planes, ms = _kernel_ms(lambda: tk.trace_planes(scal, inp, *args))
    bound, by, _ = bound_ms(0, args[2], planes[2], o.shape[0], args[3])
    return parity, {"rays": o.shape[0], "ms": ms, "bound_ms": bound,
                    "bound_by": by}


def check_adaptive(dev, size=1024):
    """Phase 18b: render.adaptive.render_adaptive of the bench scene at
    size^2 (RK4, 1000 steps; base_spp 1, extra_spp 4, edge_fraction
    0.125), timed to a synchronise, K1 launches counted.  Gates: a finite
    image; the card's selection (select_pixels) equal to the CPU's from
    the same edge map; the first refinement pass's rays of every
    ADAPTIVE_SAMPLE-th selected pixel, K1 against its plain version,
    under the RK4 contract.  Returns (stats, K1 launches)."""
    import torch

    from blackhole_tpu_torch.render import adaptive
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import trace_kernel
    from blackhole_tpu_torch.utils import profiling

    scene, camera = bench_scene(dev)
    adaptive.render_adaptive(scene, camera, 64, 64)  # warm-up
    profiling.synchronize()
    trace_kernel.launches = 0
    t0 = time.perf_counter()
    img, edges = adaptive.render_adaptive(scene, camera, size, size)
    profiling.synchronize()
    seconds = time.perf_counter() - t0
    launches = trace_kernel.launches
    check(img.shape == (size, size, 3) and bool(torch.isfinite(img).all()),
          f"adaptive image {tuple(img.shape)} is not finite")
    k = max(1, int(round(0.125 * size * size)))
    idx = adaptive.select_pixels(edges, k)
    cpu_idx = adaptive.select_pixels(edges.cpu(), k)
    check(torch.equal(idx.cpu(), cpu_idx), "the card's top-k selection "
          "differs from the CPU's on the same edge map")
    pick = idx[::ADAPTIVE_SAMPLE]
    ox, oy = cam.jitter_offsets(1, 5)
    o, d = cam.generate_rays_for_pixels(camera, size, size, pick % size,
                                        pick // size, ox, oy)
    hit_k, hit_p = kernel_and_plain(o, d, scene)
    parity = parity_stats(hit_k, hit_p, exact=True)
    return {"size": size, "ms": 1e3 * seconds, "launches": launches,
            "rays": size * size + 4 * k, "selected": k,
            "edge_ones": int((edges == 1.0).sum()),
            "sample_parity": parity}, launches


def check_orbit(dev, size=256, n_frames=4):
    """Phase 18c: viz.animate.render_orbit_animation of the bench scene,
    n_frames at size^2, into build/chip_smoke_orbit; the frames read back
    equal to render_image's at each orbit camera (to_uint8).  Returns
    (stats, K1 launches)."""
    import shutil

    import numpy as np

    from blackhole_tpu_torch.render import image, trace_kernel
    from blackhole_tpu_torch.utils import profiling
    from blackhole_tpu_torch.viz import animate, native_io
    from blackhole_tpu_torch.viz import io as viz_io

    scene, _ = bench_scene(dev)
    out = ROOT / "build" / "chip_smoke_orbit"
    shutil.rmtree(out, ignore_errors=True)
    writer = "native" if native_io.available() else "python"
    profiling.synchronize()
    trace_kernel.launches = 0
    t0 = time.perf_counter()
    paths = animate.render_orbit_animation(scene, str(out),
                                           n_frames=n_frames, width=size,
                                           height=size)
    seconds = time.perf_counter() - t0
    launches = trace_kernel.launches
    check(len(paths) == n_frames and all(Path(p).is_file() for p in paths),
          f"orbit frames missing: {paths}")
    for k, p in enumerate(paths):
        camera = animate.orbit_camera(35.0, 18.0, 360.0 * k / n_frames, 22.0,
                                      device=dev)
        ref = viz_io.to_uint8(image.render_image(scene, camera, size,
                                                 size).cpu().numpy())
        back = np.round(viz_io.read_image(p) * 255.0).astype(np.uint8)
        check(np.array_equal(back, ref), f"orbit frame {k} reads back "
              f"different from its render")
    return {"frames": n_frames, "size": size, "writer": writer,
            "ms_per_frame": 1e3 * seconds / n_frames,
            "launches": launches}, launches


def check_cli_view(proc):
    """Phase 18d: the `cli view --headless --frames 8 --width 128
    --height 72` subprocess (started beside phase 17d's): its stats
    line."""
    out, seconds = proc
    line = next((s for s in out.splitlines() if s.startswith("viewer: ")),
                None)
    check(line is not None and line.startswith("viewer: 8 frames"),
          f"cli view printed no stats line: {out[-500:]}")
    return {"view_s": seconds, "stats": line}


# Phase 19's gradient case: bench_scaling's fwd+bwd (256x256, 128 steps,
# path budget 60), the loss taken at log(mass) + 0.05 from a target at
# mass 1.  Sharded gradients are held to others within the JAX package's
# bar for its sharded gradients (tests/test_parallel.py: rtol 1e-4, atol
# 1e-7): the per-ray cotangent guard sees the sum's cotangents, n x the
# mean's, so it can clip other rays than a single-process mean does.
SHARDED_GRAD = dict(width=256, height=256, steps=128, log_mass_step=0.05)
SHARDED_GRAD_TOL = (1e-4, 1e-7)


def sharded_grad_case(dev, grad=SHARDED_GRAD):
    """(scene, camera, params) of phase 19's gradient case."""
    from blackhole_tpu_torch.grad import inverse
    from blackhole_tpu_torch.parallel import scaling

    scene = scaling._make_scene(0, grad["steps"], dev)
    camera = scaling._camera(dev)
    params = inverse.pack_params(scene, camera)
    params["log_mass"] = params["log_mass"] + grad["log_mass_step"]
    return scene, camera, params


def _grads_gap(got, want, tol=SHARDED_GRAD_TOL):
    """Largest |got - want| / (atol + rtol |want|) over a dict of
    gradients (the loss under "loss"): at most 1 where every value is
    within (rtol, atol) = tol."""
    rtol, atol = tol
    return max(float(((got[k].cpu().double() - want[k].cpu().double()).abs()
                      / (atol + rtol * want[k].cpu().double().abs())).max())
               for k in want)


def check_sharded_world1(dev, scene, camera, img_ref, size=1024,
                         grad=SHARDED_GRAD):
    """Phase 19a: a world of one rank over NCCL in this process.  The
    bench frame's render_image_sharded (kernel engine, depth-sorted) bit
    for bit phase 7's render_image, its ms (median of 3, min, max) and
    K1 launches; loss_and_grad_sharded of the gradient case against the
    single-process image_loss backward (within SHARDED_GRAD_TOL), both
    timed.
    Returns (stats, the sharded loss and gradients, the target)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from blackhole_tpu_torch.grad import inverse
    from blackhole_tpu_torch.parallel import mesh as pmesh
    from blackhole_tpu_torch.render import trace_kernel

    w, h = grad["width"], grad["height"]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.initialize_distributed(f"file://{tmp}/store", 1, 0, backend,
                                     600)
        try:
            mesh = pmesh.make_mesh(1, dev)
            check(mesh.group is not None and dist.get_backend() == backend
                  and not mesh.host_staged, f"19a is not a {backend} world")

            def frame():
                return pmesh.render_image_sharded(
                    scene, camera, size, size, mesh, engine="auto",
                    depth_sort=True)

            before = trace_kernel.launches
            img, times = _timed(frame)
            launches = trace_kernel.launches - before
            check(torch.equal(img, img_ref),
                  "the world-1 sharded frame is not bit for bit render_image")
            gscene, gcamera, params = sharded_grad_case(dev, grad)
            target = pmesh.render_image_sharded(gscene, gcamera, w, h, mesh)
            _sync()
            t0 = time.perf_counter()
            loss, grads = pmesh.loss_and_grad_sharded(params, target, gscene,
                                                      gcamera, w, h, mesh)
            _sync()
            t_sharded = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    t0 = time.perf_counter()
    loss1 = inverse.image_loss(leaves, target, gscene, gcamera, w, h)
    g1 = torch.autograd.grad(loss1, list(leaves.values()), allow_unused=True)
    _sync()
    t_single = time.perf_counter() - t0
    single = {k: torch.zeros_like(v) if g is None else g
              for (k, v), g in zip(leaves.items(), g1)}
    got = {"loss": loss, **grads}
    gap = _grads_gap(got, {"loss": loss1.detach(), **single})
    check(math.isfinite(gap) and gap <= 1.0,
          f"world-1 sharded gradients off the single-process ones: {gap}")
    return {"frame_ms": _ms_stats(times), "frame_k1_launches": launches,
            "bitwise_render_image": True, "grad_case": grad,
            "loss": float(loss), "grad_gap_vs_image_loss": gap,
            "loss_and_grad_sharded_s": t_sharded,
            "image_loss_backward_s": t_single}, got, target


def _to(tree, device):
    """A record (Scene, Camera, tensor) with every tensor on device."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: t.to(device), tree)


def world2_job(mesh, scene, camera, target, size, grad):
    """Phase 19b on one rank of a world of 2 gloo ranks sharing the card:
    the frame of (scene, camera) (kernel engine, depth-sorted; ms median
    of 3), one
    make_train_step_sharded step of the gradient case (its gradients and
    loss) and the dry run's legs (entry.dryrun_legs, what
    dryrun_multichip(2) runs in its own world), each timed; host data
    back."""
    import torch

    from blackhole_tpu_torch import entry
    from blackhole_tpu_torch.parallel import mesh as pmesh
    from blackhole_tpu_torch.render import trace_kernel

    scene, camera = _to(scene, mesh.device), _to(camera, mesh.device)
    img, times = _timed(lambda: pmesh.render_image_sharded(
        scene, camera, size, size, mesh, engine="auto", depth_sort=True))
    gscene, gcamera, params = sharded_grad_case(mesh.device, grad)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    optimizer = torch.optim.Adam(list(leaves.values()), lr=1e-2,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = pmesh.make_train_step_sharded(grad["width"], grad["height"],
                                         mesh)
    target = target.to(mesh.device)
    _sync()
    t0 = time.perf_counter()
    _, _, loss = step(leaves, optimizer, target, gscene, gcamera)
    _sync()
    t_step = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = entry.dryrun_legs(mesh)
    t_dry = time.perf_counter() - t0
    return {"rank": mesh.rank, "host_staged": mesh.host_staged,
            "image": img.cpu(), "frame_s": times, "step_s": t_step,
            "dryrun_s": t_dry, "dryrun": dry,
            "grads": {"loss": loss.cpu(),
                      **{k: v.grad.cpu() for k, v in leaves.items()}},
            "k1_launches": trace_kernel.launches}


def check_sharded_world2(scene, camera, img_ref, grads_ref, target,
                         device="cuda", size=1024, grad=SHARDED_GRAD):
    """Phase 19b: world2_job on 2 gloo ranks on the card; every rank's
    gathered frame bit for bit 19a's, its gradients within
    SHARDED_GRAD_TOL of 19a's, the dry run's errors under 1e-4 and its
    loss finite."""
    import torch

    from blackhole_tpu_torch import entry
    from blackhole_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch.run_world(
        world2_job, 2, "gloo", device, timeout_s=600,
        args=(_to(scene, "cpu"), _to(camera, "cpu"), target.cpu(), size,
              grad))
    wall = time.perf_counter() - t0
    ref = img_ref.cpu()
    stats = {"world_s": wall, "ranks": []}
    for r in ranks:
        check(r["host_staged"] == (device == "cuda"),
              "gloo ranks on a card must stage through the host")
        check(torch.equal(r["image"], ref),
              f"rank {r['rank']}'s gathered frame is not 19a's bit for bit")
        gap = _grads_gap(r["grads"], grads_ref)
        check(math.isfinite(gap) and gap <= 1.0,
              f"rank {r['rank']}'s gradients off world 1's: {gap}")
        stats["ranks"].append({
            "rank": r["rank"], "frame_ms": _ms_stats(r["frame_s"]),
            "step_s": r["step_s"], "grad_gap_vs_world1": gap,
            "dryrun_s": r["dryrun_s"], "k1_launches": r["k1_launches"]})
    entry.print_dryrun(2, ranks[0]["dryrun"])
    return stats, sum(r["k1_launches"] for r in ranks)


def export_gate(color, hit, what):
    """An exported program's colour against the live trace_rays_fast Hit
    on the same rays: the max gap over the rays whose code is not
    MAX_STEPS within 2e-4 (the RK4 and symplectic colour contract), and
    the values that differ bitwise."""
    from blackhole_tpu_torch.geom.types import RayResult

    keep = hit.result.reshape(-1) != RayResult.MAX_STEPS
    err = float((color.reshape(-1, 3) - hit.color.reshape(-1, 3))
                .abs()[keep].max())
    check(err < 2e-4, f"{what}: colour gap {err} against trace_rays_fast")
    return {"color_max": err,
            "values_differing_bitwise": int(
                (color.reshape(-1) != hit.color.reshape(-1)).sum()),
            "rays": int(hit.result.numel()),
            "rays_not_max_steps": int(keep.sum())}


def check_export(dev, scene, camera, o, d, hit_ref):
    """Phase 19c: export_trace of the bench scene with a symbolic ray
    count, called on the 1024x1024 rays, against phase 7's
    trace_rays_fast Hit on them under the RK4 colour contract (the rays
    whose code is not MAX_STEPS), the values that differ bitwise
    counted; export_render at 256x256 against trace_rays_fast of its rays
    under the same contract, following a moved camera.  Export and call
    times (calls: median of 3)."""
    import torch

    from blackhole_tpu_torch import export
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel

    t0 = time.perf_counter()
    ep = export.load(export.export_trace(scene, poly_batch=True, device=dev))
    t_export = time.perf_counter() - t0
    before = trace_kernel.launches
    color, times = _timed(lambda: export.call_trace(ep, scene, o, d))
    stats = {"trace": {"export_s": t_export, "call_ms": _ms_stats(times),
                       "k1_launches": trace_kernel.launches - before,
                       **export_gate(color, hit_ref, "exported trace")}}
    calls = len(times) + 1 if dev.type == "cuda" else 0
    check(stats["trace"]["k1_launches"] == calls,
          "the exported trace does not launch K1 once a call")

    t0 = time.perf_counter()
    ep_r = export.load(export.export_render(scene, camera, 256, 256,
                                            device=dev))
    t_export = time.perf_counter() - t0
    moved = dataclasses.replace(
        camera, position=torch.tensor([0.0, -40.0, 12.0], device=dev),
        direction=torch.tensor([0.0, 40.0, -12.0], device=dev))
    imgs = []
    for c in (camera, moved):
        img, times = _timed(lambda: export.call_render(ep_r, scene, c))
        ro, rd = cam.generate_rays(c, 256, 256)
        hit = image.trace_rays_fast(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                    scene)
        imgs.append((img, export_gate(img, hit, "exported render")))
    moved_by = float((imgs[1][0] - imgs[0][0]).abs().max())
    check(moved_by > 1e-3, "the exported render does not follow the camera")
    stats["render_256"] = {"export_s": t_export, "call_ms": _ms_stats(times),
                           "moved_camera_max_change": moved_by,
                           **imgs[0][1]}
    return stats


def check_export_xla(dev, scene, o, d):
    """Phase 19c, the XLA engine: export_trace of the scene under
    LEAPFROG and YOSHIDA with a symbolic ray count (a traced while_loop
    over trace.trace_rays's step), one call on the rays (o, d) against
    the live trace_rays_fast (the XLA engine) on them: the colour max
    over the live Hit's rays that are not MAX_STEPS under the symplectic
    integrators' contract (< 2e-4), the values that differ bitwise, and
    no K1 launch.  Export and call seconds (one call each: a call takes
    seconds), and the operators in the traced loop body (each a launch
    a step when called)."""
    from blackhole_tpu_torch import export
    from blackhole_tpu_torch.render import image, trace_kernel

    stats = {}
    for integ in ("leapfrog", "yoshida"):
        sc = dataclasses.replace(scene, config=dataclasses.replace(
            scene.config, integrator=integ))
        t0 = time.perf_counter()
        ep = export.load(export.export_trace(sc, poly_batch=True,
                                             device=dev))
        t_export = time.perf_counter() - t0
        code = ep.graph_module.code
        check("while_loop" in code and "trace_planes" not in code,
              f"the exported {integ} trace is not the XLA engine's loop")
        body_ops = sum(
            node.op == "call_function"
            for name, sub in ep.graph_module.named_children()
            if name.startswith("while_loop_body") for node in sub.graph.nodes)
        before = trace_kernel.launches
        color, t_call = _timed(lambda: export.call_trace(ep, sc, o, d),
                               repeats=1, warmup=False)
        k1 = trace_kernel.launches - before
        check(k1 == 0, f"the exported {integ} trace launched K1 {k1} times")
        hit, t_live = _timed(lambda: image.trace_rays_fast(o, d, sc),
                             repeats=1, warmup=False)
        stats[integ] = {
            "export_s": t_export, "call_s": t_call[0], "live_s": t_live[0],
            **export_gate(color, hit, f"exported {integ} trace"),
            "steps_max": int(hit.steps.max()), "loop_body_ops": body_ops,
            "k1_launches": k1}
    return stats


def check_examples(dev):
    """Phase 19d, in this process: render_kerr and lensed_starfield at
    their defaults (512x512), inverse_fit --method forward at its
    defaults (K2), each timed to a synchronise; finite images, PNGs
    written, finite losses falling."""
    import tempfile

    import torch

    from blackhole_tpu_torch.examples import (
        inverse_fit, lensed_starfield, render_kerr,
    )

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, example in (("render_kerr", render_kerr),
                              ("lensed_starfield", lensed_starfield)):
            png = Path(tmp) / f"{name}.png"
            t0 = time.perf_counter()
            img = example.main(["--out", str(png)])
            _sync()
            stats[name] = {"s": time.perf_counter() - t0,
                           "mean": float(img.mean())}
            check(img.shape == (512, 512, 3) and img.device.type == "cuda"
                  and bool(torch.isfinite(img).all())
                  and png.stat().st_size > 1000, f"{name} image")
    t0 = time.perf_counter()
    fitted, losses = inverse_fit.main(["--method", "forward"])
    stats["inverse_fit_forward"] = {
        "s": time.perf_counter() - t0, "loss_first": losses[0],
        "loss_last": losses[-1], "mass": float(fitted.blackhole.mass),
        "spin": float(fitted.blackhole.spin)}
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"inverse_fit --method forward: losses {losses[0]} -> "
          f"{losses[-1]}")
    return stats


def _watched(module, *args):
    """_python_m(module, *args) with a thread that collects the process's
    output and notes the seconds from its start to its exit (under
    "s")."""
    import threading

    proc, t0 = _python_m(module, *args)
    record = {"proc": proc}

    def watch():
        record["out"], record["err"] = proc.communicate()
        record["s"] = time.perf_counter() - t0

    record["thread"] = threading.Thread(target=watch, daemon=True)
    record["thread"].start()
    return record


def check_example_processes(procs, timeout=900):
    """Phase 19d's two _watched subprocesses {name: (record, the prefix
    of its result line)}: each exits 0 and prints its result line; wall
    times from start to exit."""
    deadline = time.perf_counter() + timeout
    stats = {}
    for name, (record, prefix) in procs.items():
        record["thread"].join(max(deadline - time.perf_counter(), 0.0))
        check(not record["thread"].is_alive()
              and record["proc"].returncode == 0,
              f"{name} exited {record['proc'].returncode}: "
              f"{record.get('err', '')[-2000:]}")
        line = next((x for x in record["out"].splitlines()
                     if x.startswith(prefix)), None)
        check(line is not None and "nan" not in line,
              f"{name} printed {record['out'][-500:]}")
        stats[name] = {"s": record["s"], "line": line}
    return stats


def phase19(dev, smi, scene, camera, img, o, d, hit):
    """Phase 19 (main's): 19a-d on phase 7's bench scene, frame (img),
    rays (o, d) and their trace_rays_fast Hit.  Returns ((K1, K2)
    launches in this process, K1 launches in the world-2 ranks)."""
    from blackhole_tpu_torch.render import trace_kernel

    t19 = time.perf_counter()
    trace_kernel.launches = trace_kernel.fwdgrad_launches = 0
    world1, grads1, target = check_sharded_world1(dev, scene, camera, img)
    print(f"sharded world 1 nccl ({smi}): {json.dumps(world1)}")
    # The reverse fit and distributed_render (its own world of one rank)
    # run as subprocesses beside 19b-d, which share the card with them.
    procs = {
        "inverse_fit_reverse": (_watched(
            "blackhole_tpu_torch.examples.inverse_fit", "--method",
            "reverse", "--fit-steps", "2"), "start mass="),
        "distributed_render_world1": (_watched(
            "blackhole_tpu_torch.examples.distributed_render", "--world",
            "1"), "one distributed fwd+bwd step")}
    try:
        world2, world2_launches = check_sharded_world2(scene, camera, img,
                                                       grads1, target)
        print(f"sharded world 2 gloo, two ranks sharing the card, "
              f"collectives staged through the host ({smi}): "
              f"{json.dumps(world2)}")
        print(f"export ({smi}): "
              f"{json.dumps(check_export(dev, scene, camera, o, d, hit))}")
        print(f"export, XLA engine ({smi}): "
              f"{json.dumps(check_export_xla(dev, scene, o, d))}")
        print(f"examples ({smi}): {json.dumps(check_examples(dev))}")
        print(f"example processes ({smi}): "
              f"{json.dumps(check_example_processes(procs))}")
    finally:
        for record, _ in procs.values():
            if record["proc"].poll() is None:
                record["proc"].kill()
                record["proc"].wait()
    launches = (trace_kernel.launches, trace_kernel.fwdgrad_launches)
    check(launches[0] >= 1 and launches[1] >= 1,
          f"phase 19 launched K1 {launches[0]} and K2 {launches[1]} times")
    print(f"phase 19: {time.perf_counter() - t19:.1f} s, K1 launches "
          f"{launches[0]} here and {world2_launches} in the world-2 ranks, "
          f"K2 launches {launches[1]}")
    return launches, world2_launches


_VARIANT = re.compile(r"(trace_kernel|fwdgrad_kernel)I(Li\d+E)?"
                      r"Lb(\d)ELb(\d)ELb(\d)E")


def variant_of(symbol):
    """(tangents, disk, adaptive, track) of a kernel's mangled name (K1:
    0 tangents), or None."""
    m = _VARIANT.search(symbol)
    if not m:
        return None
    return (int(m[2][2:-1]) if m[2] else 0, *(bool(int(m[k])) for k in
                                               (3, 4, 5)))


def variant_name(v):
    tan, disk, adaptive, track = v
    return (f"{'K1' if tan == 0 else f'K2 n={tan}'} "
            f"{'rkf45' if adaptive else 'rk4'}{' disk' if disk else ''}"
            f"{' track' if track else ''}")


def print_ptxas(libs):
    """ptxas's registers and spills of every kernel variant built."""
    for path in libs.values():
        variant = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            v = variant_of(line)
            if v and "Compiling entry function" in line:
                variant = variant_name(v)
            elif "registers" in line or "spill" in line:
                print(f"ptxas {variant}: {line.split(':', 1)[-1].strip()}")


# The SASS opcodes the anatomy counts in the step loop: the reciprocal and
# reciprocal square root estimates (IEEE division and sqrt start there),
# the division's range check, FP32 arithmetic, local-memory loads and
# stores (spills, or arrays kept in local memory), and calls (a
# division's or sqrt's slow path).
SASS_OPS = ("MUFU.RCP", "MUFU.RSQ", "FCHK", "FFMA", "FMUL", "FADD", "LDL",
            "STL", "CALL")


def cuobjdump_path():
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    return str(cand) if cand.exists() else None


def sass_mix(lib_path):
    """{variant: {op: count}} for every kernel in the library, from
    cuobjdump -sass: the SASS_OPS and all instructions ("instructions")
    in the step loop, the backward branch of the widest span (the per-ray
    loop, the step inlined), and in the whole kernel ("kernel"); None
    without cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    insn = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
    for func in funcs:
        v = variant_of(func.split("\n", 1)[0])
        if v is None:
            continue
        ops, labels, pending = [], {}, []
        for line in func.splitlines():
            lab = re.match(r"^\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab[1])
                continue
            m = insn.match(line)
            if m:
                addr = int(m[1], 16)
                for name in pending:
                    labels[name] = addr
                pending = []
                ops.append((addr, m[2], m[3]))
        span = (0, -1)
        for addr, op, rest in ops:
            if not op.startswith("BRA"):
                continue
            # The target: a label, `(.L_x_12), or an address, 0x1230.
            t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", rest)
            start = (labels.get(t[1], addr) if t and t[1] else
                     int(t[2], 16) if t else addr)
            if start < addr and addr - start > span[1] - span[0]:
                span = (start, addr)

        def count(sel):
            c = {k: 0 for k in SASS_OPS}
            n = 0
            for addr, op, _ in sel:
                n += 1
                key = op if op.startswith("MUFU") else op.split(".")[0]
                if key in c:
                    c[key] += 1
            c["instructions"] = n
            return c

        loop = count([x for x in ops if span[0] <= x[0] <= span[1]])
        loop["kernel"] = len(ops)
        out[v] = loop
    return out


def group_max_steps(steps, width=32):
    """Each group's largest step count: consecutive groups of `width` rays
    in launch order (a warp of 32, or a block), the last one padded with
    idle lanes."""
    import torch

    s = steps.double().flatten()
    s = torch.cat([s, s.new_zeros((-s.numel()) % width)])
    return s.view(-1, width).amax(1)


def launch_shares(steps, width):
    """The share of lane-steps that do work when consecutive threads in
    groups of `width` (a warp of 32, or a block) hold their resources
    until the group's slowest ray retires: sum of steps over the sum, per
    group, of width x its largest step count, in launch order."""
    return float(steps.double().sum()
                 / (width * group_max_steps(steps, width)).sum())


def regime(steps, ms, floor_ms, loop_insns, warps_per_sm, sms, clock_mhz):
    """The two regimes of a K1 launch from its step-count plane (launch
    order) and its time: rays, warps and waves (warps over the resident
    warps of all SMs), mean and max steps; the static issue ceiling, the
    step loop's SASS instructions times the sum over warps of the warp's
    largest step count, over SMs x 4 schedulers x the SM clock (one warp
    instruction per scheduler and cycle); the tail floor, the time of the
    same kernel on the 32 rays of the slowest warp alone; both as shares
    of the launch's time.  loop_insns None (no cuobjdump): no ceiling."""
    s = steps.double().flatten()
    warp_steps = float(group_max_steps(s).sum())
    ceiling = (None if loop_insns is None else
               1e3 * loop_insns * warp_steps / (sms * 4 * clock_mhz * 1e6))
    n_warps = -(-s.numel() // 32)
    return {"rays": s.numel(), "warps": n_warps,
            "waves": n_warps / (warps_per_sm * sms),
            "mean_steps": float(s.mean()), "max_steps": float(s.max()),
            "warp_steps": warp_steps, "sass_loop": loop_insns,
            "sm_clock_mhz": clock_mhz, "ms": ms,
            "issue_ceiling_ms": ceiling,
            "issue_share": None if ceiling is None else ceiling / ms,
            "tail_floor_ms": floor_ms, "tail_share": floor_ms / ms}


def sm_clock_mhz(launch, ms):
    """The SM clock nvidia-smi reads while about 0.6 s of `launch` (a
    kernel of `ms` each) is queued on the card."""
    import torch

    for _ in range(max(2, math.ceil(600.0 / max(ms, 1e-3)))):
        launch()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def k1_occupancy(disk_on, adaptive, track):
    """(resident warps per SM, SMs) of a K1 variant on this card."""
    import torch

    from blackhole_tpu_torch import cuda_lib

    return (cuda_lib.attributes(0, disk_on, adaptive, track)["warps_per_sm"],
            torch.cuda.get_device_properties(0).multi_processor_count)


def k1_launches(dev, size=1024):
    """Every K1 launch of the main path (phases 7-8) and the soft path
    (phase 9) at image size `size`: [(name, scene, o, d)], the rays in
    the launch's order: render_image's depth-order prepasses (size / 8
    per side, raster order) and its renders (depth order), and the
    gradient half's prepasses; and, timed beside them, K1-track RKF45 on
    the soft scene's size x size rays in raster order."""
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    out = []
    for tag, softness in (("K1", 0.0), ("K1-track", 0.3)):
        rk4, camera = bench_scene(dev, softness=softness)
        rkf45, _ = bench_scene(dev, "rkf45", softness=softness)
        cases = [("rk4 prepass", rk4, size // 8, False),
                 ("rk4 render", rk4, size, True),
                 ("rkf45 prepass", rkf45, size // 8, False)]
        if softness == 0.0:
            cases += [("rkf45 prepass", rkf45, size // 16, False),
                      ("rkf45 render", rkf45, size // 2, True)]
        else:
            cases += [("rkf45 raster", rkf45, size, False)]
        for what, scene, n, depth in cases:
            o, d = cam.generate_rays(camera, n, n)
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            if depth:
                order = image.predicted_depth_order(scene, camera, n, n)
                o, d = o[order], d[order]
            out.append((f"{tag} {what} {n}^2", scene, o, d))
    return out


def print_regimes(dev, mixes, card, size=1024):
    """Phase 12: one `regime:` line per K1 launch of k1_launches: its
    time (CUDA events, median of 3), the SM clock beside it, and
    regime()'s issue ceiling (the variant's SASS loop from mixes, None
    without) and tail floor (median of 5), with the card."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    rows = []
    for name, scene, o, d in k1_launches(dev, size):
        scal, inp = tk.prepare(o, d, scene)
        args = tk.planes_args(scene)
        disk_on, _, adaptive, track = args
        planes, ms = _kernel_ms(lambda: tk.trace_planes(scal, inp, *args))
        steps = planes[2]
        w = int(group_max_steps(steps).argmax())
        tail = inp[:, 32 * w:32 * (w + 1)].contiguous()
        _, floor_ms = _kernel_ms(
            lambda: tk.trace_planes(scal, tail, *args), repeats=5)
        mhz = sm_clock_mhz(lambda: tk.trace_planes(scal, inp, *args), ms)
        loop = mixes.get((0, disk_on, adaptive, track), {}).get("instructions")
        row = {"launch": name, "card": card,
               **regime(steps, ms, floor_ms, loop,
                        *k1_occupancy(disk_on, adaptive, track), mhz)}
        print(f"regime: {json.dumps(row)}")
        rows.append(row)
    return rows


def print_anatomy(libs, launches):
    """Phase 12: every kernel variant's launch shape on this card (block,
    resident blocks and warps per SM, registers, local memory), its
    divisions and square roots per step (DIVS_PER_STEP, disk on) and its
    step loop's SASS mix (sass_mix); then, for launches {name: (steps
    plane in raster order, depth order, block)}, the lane share (warps of
    32) and the block share (blocks of 32, 64, 96, 128: the block sizes
    the kernels may take) in raster and in depth-sorted launch order.
    Returns the SASS mixes {variant: mix}."""
    from blackhole_tpu_torch import cuda_lib

    mixes = {}
    for name, path in libs.items():
        mix = sass_mix(path)
        if mix is None:
            print(f"anatomy: cuobjdump not found: no SASS mix for {name}")
        mixes.update(mix or {})
    for name in libs:
        tans = (0,) if name == "trace" else (1, 2)
        for tan in tans:
            for disk, adaptive, track in ((False, False, False),
                                          (False, True, False),
                                          (True, False, False),
                                          (True, True, False),
                                          (True, False, True),
                                          (True, True, True)):
                v = (tan, disk, adaptive, track)
                row = {"variant": variant_name(v),
                       **cuda_lib.attributes(tan, disk, adaptive, track)}
                if disk:
                    divs, sqrts = DIVS_PER_STEP[(tan, adaptive, track)]
                    row.update(divs_per_step=divs, sqrts_per_step=sqrts)
                if v in mixes:
                    row["sass_loop"] = mixes[v]
                print(f"anatomy: {json.dumps(row)}")
    for name, (steps, order, block) in launches.items():
        for how, perm in (("raster", None), ("depth", order)):
            st = steps if perm is None else steps[perm]
            shares = {f"share_{w}": round(launch_shares(st, w), 4)
                      for w in (32, 64, 96, 128)}
            print(f"lane share {name} ({how} order, block {block}): "
                  f"{json.dumps(shares)}")
    return mixes


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

    print(f"[{time.perf_counter() - T0:.1f} s] phase 2")
    # 2. Build the kernels from this checkout's sources.
    from blackhole_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    libs = cuda_lib.build()
    for name in libs:
        cuda_lib.load(name)
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    print_ptxas(libs)
    # The CPU's share of phases 15 and 16 runs beside the card's phases.
    import multiprocessing

    cpu_pool = multiprocessing.get_context("spawn").Pool(1)
    # Phase 8's plain K2 passes run on the card beside phases 3-6.
    plain_pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        plain_jobs = {w: plain_pool.apply_async(plain_main_shapes, (w,))
                      for w in ("rk4", "rkf45")}
        return _main_phases(smi, dev, libs, cpu_pool.apply_async(
            cpu_references).get, plain_jobs)
    finally:
        for pool in (cpu_pool, plain_pool):
            pool.terminate()
            pool.join()


def _main_phases(smi, dev, libs, cpu_ref, plain_jobs) -> int:
    """Phases 3-18 and the last three lines (main's); cpu_ref() returns
    cpu_references' result."""
    import torch

    from blackhole_tpu_torch import cuda_lib

    print(f"[{time.perf_counter() - T0:.1f} s] phase 3")
    # 3. K1 against plain on the card.
    for stats in check_kernel_vs_plain(dev):
        print(f"parity K1: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 4")
    # 4. K2 against plain on the card.
    plains = {}
    fwd_stats = check_fwdgrad_vs_plain(dev, plains=plains)
    for stats in fwd_stats:
        print(f"parity K2: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 3-4 (track)")
    # 3-4. The tracking variants against plain on the card.
    for stats in check_track_vs_plain(dev, plains=plains):
        print(f"parity {stats['kernel']}: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 5")
    # 5. K3: jvp through the trace.
    print(f"K3 jvp: {json.dumps(check_k3(dev))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 5b")
    # 5b. K1 and K2 after one and two steps against their plain versions.
    for stats in check_one_step(dev):
        print(f"one-step: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 6")
    # 6. Depth-sorted against raster.
    print(f"depth-sorted: {json.dumps(check_depth_sorted(dev))}")

    from blackhole_tpu_torch.geom.types import RayResult
    from blackhole_tpu_torch.grad import fast_grad
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image, trace_kernel

    # Phase 8's plain passes (plain_main_shapes) end before phase 7's
    # timings start.
    plains = {w: (tuple(t.to(dev) for t in job.get()[0]), job.get()[1])
              for w, job in plain_jobs.items()}
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
    planes_k, ms_k = _kernel_ms(
        lambda: trace_kernel.trace_planes(scal, inp, *args))
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
    time_k1_launches(camera, scene, scene45)

    print(f"[{time.perf_counter() - T0:.1f} s] phase 8")
    # 8. The gradient half of the main path (bench.py's fwd+bwd).
    trace_kernel.launches = trace_kernel.fwdgrad_launches = 0
    t0 = time.perf_counter()
    grad_runs = {name: fwdbwd(base, camera, o, d)
                 for name, base in (("rk4", scene), ("rkf45", scene45))}
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = (trace_kernel.launches, trace_kernel.fwdgrad_launches)
    print(f"main path (gradient): scene_value_and_grad 1024^2 rk4 + rkf45 in "
          f"{grad_s:.3f} s, launches K1 {grad_launches[0]} K2 "
          f"{grad_launches[1]}")
    check(grad_launches[1] >= 1, "the gradient path launched no K2")
    check_gradients({f"{k} 1024^2": v for k, v in grad_runs.items()})
    for name, base in (("rk4", scene), ("rkf45", scene45)):
        time_fwdbwd(name, base, camera, o, d)

    k2, plain_s, k2_steps = check_fwdgrad_main_shapes(o, d, scene, scene45,
                                                      planes_k, ms_k, plains)

    print(f"[{time.perf_counter() - T0:.1f} s] phase 9")
    # 9. The soft path at 1024^2.
    track_rows, track_steps = soft_path(dev, camera, o, d, plain_s)

    print(f"[{time.perf_counter() - T0:.1f} s] phase 10")
    # 10. Gradient fidelity of the soft boundary.
    print(f"fidelity AD/FD 256^2 800 steps: {json.dumps(check_fidelity(dev))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 11")
    # 11. fit_forward.
    print(f"fit_forward 256^2 rkf45: {json.dumps(check_fit(dev))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 12")
    # 12. The kernels' anatomy: launch shapes, SASS mix, lane shares.
    orders = {integ: image.predicted_depth_order(sc, camera, 1024, 1024)
              for integ, sc in (("rk4", scene), ("rkf45", scene45))}
    k1_block = cuda_lib.attributes(0, True, False, False)["block"]
    k2_block = cuda_lib.attributes(2, True, False, False)["block"]
    mixes = print_anatomy(libs, {
        name: (st, orders["rkf45" if "rkf45" in name else "rk4"],
               k1_block if name.startswith("K1") else k2_block)
        for name, st in {"K1 rk4": planes_k[2], **k2_steps,
                         **track_steps}.items()})
    # The two regimes of every K1 launch of the main and soft paths.
    print_regimes(dev, mixes, smi)

    print(f"[{time.perf_counter() - T0:.1f} s] phase 13")
    # 13. The XLA engine on the card against K1.
    for stats in check_xla_engine(dev, camera, scene, scene45):
        print(f"xla engine: {json.dumps(stats)}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 14")
    # 14. Reverse mode against finite differences, float64.
    print(f"reverse mode AD/FD 8^2 f64: {json.dumps(check_reverse_fd(dev))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 15")
    # 15. The reverse half of the main path (bench.py's BENCH_GRAD=bucketed).
    rev = check_reverse_path(dev, scene, o, d, ms_k,
                             [float(grad_runs["rk4"][1][k])
                              for k in ("mass", "spin")], cpu_ref)

    print(f"[{time.perf_counter() - T0:.1f} s] phase 16")
    # 16. The reverse-mode fit.
    print(f"fit: {json.dumps(check_reverse_fit(dev, cpu_ref))}")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 17")
    # 17. The bh_* API, the particle simulator and the CLI on the card.
    t17 = time.perf_counter()
    trace_kernel.launches = 0
    api_hits, rays = check_api_rays(dev)
    print(f"api rays: {json.dumps(rays)}")
    frame = check_api_frame(dev, o, d, hit)
    api_launches = trace_kernel.launches
    print(f"api bench frame 1024^2 rk4 ({smi}): {json.dumps(frame)}")
    for stats in check_particles(dev):
        print(f"api particles ({smi}): {json.dumps(stats)}")
    # Phase 18d's `cli view` starts beside phase 17d's two subprocesses;
    # it ends before phase 18a starts, so no process of its own shares
    # the card or the host with the served session's timings.
    view = _cli("view", "--headless", "--frames", "8", "--width", "128",
                "--height", "72")
    try:
        print(f"cli ({smi}): {json.dumps(check_cli(api_hits))}")
        print(f"phase 17: {time.perf_counter() - t17:.1f} s, K1 launches "
              f"{api_launches}")

        print(f"[{time.perf_counter() - T0:.1f} s] phase 18")
        # 18. The front ends on the card.
        t18 = time.perf_counter()
        view_stats = check_cli_view(_cli_done(*view))
    finally:
        if view[0].poll() is None:
            view[0].kill()
            view[0].wait()
    served, served_launches = check_served_session(dev)
    print(f"served session ({smi}): {json.dumps(served)}")
    adapt, adapt_launches = check_adaptive(dev)
    print(f"adaptive 1024^2 rk4 ({smi}): {json.dumps(adapt)}")
    orbit, orbit_launches = check_orbit(dev)
    print(f"orbit animation ({smi}): {json.dumps(orbit)}")
    print(f"cli view ({smi}): {json.dumps(view_stats)}")
    front_launches = served_launches + adapt_launches + orbit_launches
    print(f"phase 18: {time.perf_counter() - t18:.1f} s, K1 launches "
          f"{front_launches} (served {served_launches}, adaptive "
          f"{adapt_launches}, orbit {orbit_launches})")

    print(f"[{time.perf_counter() - T0:.1f} s] phase 19")
    # 19. Sharded rendering, export and the examples on the card.
    sharded_launches, world2_launches = phase19(dev, smi, scene, camera, img,
                                                o, d, hit)
    print(f"[{time.perf_counter() - T0:.1f} s] done")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "trace_planes", **KERNELS["trace_planes"],
         "launches": (fwd_launches[0] + rev["launches"] + api_launches
                      + front_launches + sharded_launches[0]
                      + world2_launches),
         "max_abs_err": big["color_max"],
         "ms": ms_k, "plain_ms": ms_p, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "trace_planes_fwdgrad", **KERNELS["trace_planes_fwdgrad"],
         **k2, "launches": grad_launches[1] + sharded_launches[1]},
        *track_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
