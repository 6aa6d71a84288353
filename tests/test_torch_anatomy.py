"""chip_smoke.py's kernel anatomy and one-step helpers, on the CPU.

The anatomy phase reads the kernels' launches (lane and block shares from
a step-count plane) and their SASS (the step loop's instruction mix from
cuobjdump's listing); the one-step phase compares planes per ray in the
CPU twin's two kinds.  These hold the arithmetic and the parsing on
made-up inputs; the card runs them on the kernels (chip_smoke.py).
"""

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
