"""chip_smoke.py's kernel anatomy and one-step helpers, on the CPU.

The anatomy phase reads the kernels' launches (lane and block shares from
a step-count plane) and their SASS (the step loop's instruction mix from
cuobjdump's listing); the one-step phase compares planes per ray in the
CPU twin's two kinds.  These hold the arithmetic and the parsing on
made-up inputs; the card runs them on the kernels (chip_smoke.py).
"""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)  # see tests/test_torch_step.py

# A cuobjdump -sass listing of one K1 variant in its layout: a loop from
# .L_x_3 back to a predicated branch, a forward branch over a slow-path
# call inside it, and the trailing branch to itself.
_LISTING = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_112trace_kernelILb1ELb0ELb0EEEvPKfPfxi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_3:
        /*0020*/                   FFMA R2, R3, c[0x3][0x4], R2 ;
        /*0030*/                   MUFU.RCP R4, R5 ;
        /*0040*/                   FCHK P0, R6, R5 ;
        /*0050*/              @!P0 BRA `(.L_x_5) ;
        /*0060*/                   CALL.REL.NOINC `($_slowpath) ;
.L_x_5:
        /*0070*/                   LDL.LU R7, [R1+0x4] ;
        /*0080*/                   FMUL R8, R7, R7 ;
        /*0090*/               @P1 BRA `(.L_x_3) ;
        /*00a0*/                   STL [R1], R8 ;
        /*00b0*/                   EXIT ;
.L_x_9:
        /*00c0*/                   BRA `(.L_x_9);
"""


@pytest.mark.parametrize("targets", ["labels", "addresses"])
def test_sass_mix_counts_the_step_loop(monkeypatch, targets):
    """The step loop is the widest backward branch, whether cuobjdump
    names branch targets by label or by address."""
    listing = _LISTING
    if targets == "addresses":
        for label, addr in ((".L_x_5", "0x70"), (".L_x_3", "0x20"),
                            (".L_x_9", "0xc0")):
            listing = listing.replace(f"`({label})", addr)
    monkeypatch.setattr(chip_smoke, "cuobjdump_path", lambda: "cuobjdump")
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, listing, ""))
    mix = chip_smoke.sass_mix("lib.so")
    assert list(mix) == [(0, True, False, False)]
    loop = mix[(0, True, False, False)]
    assert loop["instructions"] == 8 and loop["kernel"] == 13
    assert (loop["MUFU.RCP"], loop["FCHK"], loop["FFMA"], loop["FMUL"],
            loop["LDL"], loop["STL"], loop["CALL"]) == (1, 1, 1, 1, 1, 0, 1)
    assert chip_smoke.variant_name((2, True, True, True)) == \
        "K2 n=2 rkf45 disk track"


def test_sass_mix_without_cuobjdump(monkeypatch):
    monkeypatch.setattr(chip_smoke, "cuobjdump_path", lambda: None)
    assert chip_smoke.sass_mix("lib.so") is None


@pytest.mark.parametrize("width", [2, 32, 96])
def test_launch_shares(width):
    """Sum of steps over the sum per group of width x its largest count:
    1 for equal steps, the mean over the max for one group, and an
    unfilled last group counts its missing lanes as idle."""
    rng = np.random.default_rng(5)
    assert chip_smoke.launch_shares(torch.full((4 * width,), 7.0),
                                    width) == 1.0
    s = torch.from_numpy(rng.integers(1, 500, width).astype(np.float32))
    assert chip_smoke.launch_shares(s, width) == pytest.approx(
        float(s.double().mean() / s.max()))
    s = torch.from_numpy(rng.integers(1, 500, 3 * width + 1)
                         .astype(np.float32))
    groups = torch.cat([s.double(), torch.zeros(width - 1,
                                                dtype=torch.float64)])
    want = float(s.double().sum()
                 / (width * groups.view(-1, width).amax(1)).sum())
    assert chip_smoke.launch_shares(s, width) == pytest.approx(want)


def test_one_step_gaps_by_kind():
    """Each plane's gap over (|plain| + the largest |plain| of its kind);
    the last chord direction apart; equal values and NaN on both sides
    are no gap."""
    plain = torch.ones(22, 3)
    plain[3] = torch.tensor([100.0, 1.0, 1.0])  # a length: kind max 100
    kern = plain.clone()
    kern[3, 1] += 1.01  # length plane, ray 1
    kern[6, 2] += 0.02  # chord direction, ray 2
    kern[10, 0] = plain[10, 0] = float("nan")
    rest, chord = chip_smoke.one_step_gaps(kern, plain, track=True)
    assert rest.tolist() == pytest.approx([0.0, 1.01 / 101.0, 0.0])
    assert chord.tolist() == pytest.approx([0.0, 0.0, 0.02 / 2.0])


def test_one_step_check_runs_on_cpu():
    """The phase's cases and control flow at 8x8 on the CPU, where both
    sides are the plain versions: every gap is 0, and the controller
    states' second steps are held per ray where a clamp set them."""
    stats = chip_smoke.check_one_step("cpu", size=8)
    assert len(stats) == 16
    assert {(s["states"], s["integrator"], s["disk"], s["track"],
             s["steps"]) for s in stats} == {
        ("parity", i, d, t, n) for i in ("rk4", "rkf45")
        for d, t in ((False, False), (True, False), (True, True))
        for n in (1, 2)} | {(c, "rkf45", True, t, 2)
                            for c in ("clamped", "rejected")
                            for t in (False, True)}
    assert all(s["primal_max"] == s["tangent_max"] == 0.0 for s in stats)
    assert all(s["advanced"] == 64 for s in stats
               if s["states"] == "parity")
    assert all(s["held_rays"] == 64 for s in stats
               if not (s["integrator"] == "rkf45" and s["steps"] == 2))
    assert all(s["held_rays"] > 0 for s in stats
               if s["states"] == "clamped")


def test_clamped_rays_are_rejected_first_steps_deaf_to_the_tolerance():
    """At the clamped controller states every first step is rejected;
    the rays held per ray are those whose second step does not move when
    the tolerance is halved or doubled; at the parity states no first
    step is rejected, so no ray is held there."""
    from blackhole_tpu_torch.render import trace_kernel as tk

    for scene, o, d, want_held in (
            (*chip_smoke.controller_scene("cpu", 8), True),
            (*[chip_smoke.parity_scene(0.9, True, "rkf45", "cpu", 8)[i]
               for i in (0, 2, 3)], False)):
        planes_in, _ = tk.prepare_fwdgrad(
            o, d, scene, chip_smoke.mass_spin_tangents(scene))
        disk_on, _, adaptive, track = tk.planes_args(scene)
        first = tk.trace_planes_plain(planes_in[0], planes_in[2], disk_on, 1,
                                      adaptive, track)
        args = (disk_on, 2, adaptive, track)
        plain = tk.trace_planes_fwdgrad_plain(*planes_in, *args)
        held = chip_smoke.clamped_rays(o, d, scene, args, plain, first)
        rejected = (first[0] == -1.0) & (first[1] == 0.0)
        assert bool(rejected.all()) == want_held
        assert bool((held & ~rejected).any()) is False
        assert bool(held.any()) == want_held


def test_regime_arithmetic():
    """The static issue ceiling is the loop's instructions times the sum
    of each warp's largest step count over SMs x 4 x the clock; waves are
    warps over the resident warps of all SMs; the last warp's idle lanes
    count no steps."""
    steps = torch.tensor([10.0] * 32 + [1.0] * 31 + [50.0] + [7.0] * 3)
    row = chip_smoke.regime(steps, ms=2.0, floor_ms=0.5, loop_insns=1000,
                            warps_per_sm=4, sms=2, clock_mhz=1000.0)
    assert row["rays"] == 67 and row["warps"] == 3
    assert row["waves"] == pytest.approx(3 / 8)
    assert row["warp_steps"] == 10.0 + 50.0 + 7.0
    assert row["max_steps"] == 50.0
    assert row["mean_steps"] == pytest.approx(float(steps.double().mean()))
    want = 1000 * 67.0 / (2 * 4 * 1000e6) * 1e3
    assert row["issue_ceiling_ms"] == pytest.approx(want)
    assert row["issue_share"] == pytest.approx(want / 2.0)
    assert row["tail_share"] == 0.25
    none = chip_smoke.regime(steps, 2.0, 0.5, None, 4, 2, 1000.0)
    assert none["issue_ceiling_ms"] is None and none["issue_share"] is None


def test_regimes_run_on_cpu(monkeypatch, capsys):
    """Phase 12's regime lines at 16x16 on the CPU, where the launches are
    the plain version's: every K1 launch of the main and soft paths (the
    prepasses at a sixteenth and an eighth of the side, the renders in
    depth order), the tail floor timed on the 32 rays of the slowest
    warp, which is the one with the largest step count."""
    import time

    from blackhole_tpu_torch.render import trace_kernel as tk

    def cpu_ms(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, 1e3 * (time.perf_counter() - t0)

    tails = []
    plain = tk.trace_planes

    def traced(scal, inp, *args):
        tails.append(inp.shape[1])
        return plain(scal, inp, *args)

    bench = chip_smoke.bench_scene

    def short(*a, **k):  # 20 steps: the plain version steps on the CPU
        scene, camera = bench(*a, **k)
        return dataclasses.replace(scene, config=dataclasses.replace(
            scene.config, max_steps=20)), camera

    monkeypatch.setattr(chip_smoke, "bench_scene", short)
    monkeypatch.setattr(chip_smoke, "_cuda_ms", cpu_ms)
    monkeypatch.setattr(chip_smoke, "sm_clock_mhz", lambda launch, ms: 1980.0)
    monkeypatch.setattr(chip_smoke, "k1_occupancy", lambda *v: (20, 132))
    monkeypatch.setattr(tk, "trace_planes", traced)
    rows = chip_smoke.print_regimes("cpu", {(0, True, False, False):
                                            {"instructions": 900}},
                                    "a card, 700 W", size=16)
    names = [r["launch"] for r in rows]
    assert names == ["K1 rk4 prepass 2^2", "K1 rk4 render 16^2",
                     "K1 rkf45 prepass 2^2", "K1 rkf45 prepass 1^2",
                     "K1 rkf45 render 8^2", "K1-track rk4 prepass 2^2",
                     "K1-track rk4 render 16^2", "K1-track rkf45 prepass 2^2",
                     "K1-track rkf45 raster 16^2"]
    assert capsys.readouterr().out.count("regime: ") == 9
    assert rows[1]["rays"] == 256 and rows[1]["warps"] == 8
    assert rows[1]["issue_ceiling_ms"] is not None
    assert all(r["issue_ceiling_ms"] is None for r in rows[2:])
    assert all(r["card"] == "a card, 700 W" and r["tail_floor_ms"] > 0
               for r in rows)
    # Each launch's tail pass runs 32 rays (fewer when the launch has).
    assert 32 in tails and all(r["max_steps"] <= 20 for r in rows)
