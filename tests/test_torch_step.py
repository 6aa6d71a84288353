"""The geodesic step of the PyTorch port against the JAX package.

* step_update (the plain version of the CUDA kernel's step) against the
  JAX package's pallas_kernel._step_update, which is pure jnp and runs
  eagerly on the CPU outside Pallas: same random float32 state and
  scalars, all 21 output slots compared component by component.
* The CPU twin: csrc/geodesic_step.cuh, the arithmetic the CUDA kernel
  runs, compiled with g++ (-ffp-contract=off, no torch headers) into a
  host loop and held against trace_planes_plain on whole traces.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.render import trace_kernel

CSRC = Path(trace_kernel.__file__).resolve().parent.parent / "csrc"

_K = trace_kernel
# Both sides run the same float32 operations in the same order.  They
# differ only where the libraries' elementwise functions round
# differently: jax.lax.rsqrt is not correctly rounded, torch.rsqrt is
# (1 ulp on the renormalised trig slots), and log/exp in the RKF45
# controller.  Tolerance per slot class (rtol, atol):
TOLERANCE = {
    # Discrete slots: exact.
    **{s: (0.0, 0.0) for s in (_K.S_RESULT, _K.S_STEPS)},
    # Integrated BL state and t: identical operations (a couple of ulp).
    **{s: (1e-6, 0.0) for s in (_K.S_R, _K.S_TH, _K.S_PH, _K.S_PR,
                                _K.S_PTH, _K.S_T)},
    # Step size: the RKF45 controller's log/exp, and the disk-aware clamp,
    # which scales h by the plane height z' (cartesian rounding) over its
    # change in the step.
    _K.S_H: (1e-3, 0.0),
    # Trig slots: 2 ulp at magnitude 1.
    **{s: (0.0, 2.4e-7) for s in (_K.S_ST, _K.S_CT, _K.S_SP, _K.S_CP)},
    # Cartesian positions and lengths at radii up to 90 built from the
    # trig slots: 4 ulp at magnitude 100.
    **{s: (0.0, 5e-5) for s in (_K.S_DIST, _K.S_HX, _K.S_HY, _K.S_HZ,
                                _K.S_MINR)},
    # Last chord direction: position rounding (5e-5) divided by chord
    # lengths down to 5e-3.
    **{s: (0.0, 1e-2) for s in (_K.S_LX, _K.S_LY, _K.S_LZ)},
}


def _random_state(n, seed, incl):
    """Float32 (state, scal) near the regimes the step decides on:
    disk-plane crossings, capture, budget and escape."""
    rng = np.random.default_rng(seed)
    f = np.float32
    M, spin, Q = 1.0, 0.9, 0.0
    a = spin * M
    r_plus = M + math.sqrt(M * M - a * a - Q * Q)
    group = rng.random(n)
    near_hole = group < 0.2
    near_disk = (group >= 0.2) & (group < 0.55)
    r = np.where(near_hole, rng.uniform(1.02 * r_plus, 2.0, n),
                 rng.uniform(2.0, 90.0, n))
    # Near-disk rays sit in the annulus, close to the plane inclined by
    # incl about x (at phi = pi/2 that is theta = pi/2 - incl).
    r = np.where(near_disk, rng.uniform(6.0, 20.0, n), r)
    th = np.where(near_disk, 0.5 * np.pi - incl + rng.normal(0, 0.02, n),
                  rng.uniform(0.1, np.pi - 0.1, n))
    ph = np.where(near_disk, 0.5 * np.pi + rng.normal(0, 0.05, n),
                  rng.uniform(0, 2 * np.pi, n))
    pr = rng.normal(0, 1.0, n)
    pth = rng.normal(0, 2.0, n)
    drift = 1.0 + rng.normal(0, 1e-4, (4, n))
    trig = [np.sin(th) * drift[0], np.cos(th) * drift[1],
            np.sin(ph) * drift[2], np.cos(ph) * drift[3]]
    dist = rng.uniform(0, 85.0, n)
    steps = rng.integers(0, 200, n).astype(float)
    result = np.where(rng.random(n) < 0.8, -1.0,
                      rng.integers(0, 4, n).astype(float))
    hxyz = rng.normal(0, 10, (3, n))
    lxyz = rng.normal(0, 1, (3, n))
    t = rng.uniform(0, 50, n)
    h = rng.uniform(0.005, 0.5, n)
    min_r = np.minimum(r, rng.uniform(2.0, 90.0, n))
    state = [r, th, ph, pr, pth, *trig, dist, steps, result, *hxyz, *lxyz,
             t, h, min_r]
    r_shell = 2 * M * (1 + math.cos(2 / 3 * math.acos(-spin)))
    scal = [M, a, Q, 0.1, 80.0, 1.01 * r_plus, 6.0, 20.0, math.sin(incl),
            math.cos(incl), 1e-6, r_shell]
    L = rng.normal(0, 4.0, n)
    return ([np.asarray(s, f) for s in state],
            [np.asarray(s, f) for s in scal] + [np.asarray(L, f)])


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "rkf45"])
@pytest.mark.parametrize("disk,incl", [(True, 0.0), (True, 0.3),
                                       (False, 0.0)],
                         ids=["disk", "disk-inclined", "no-disk"])
def test_step_update_matches_jax(adaptive, disk, incl):
    state, scal = _random_state(4096, seed=3 + int(adaptive), incl=incl)
    ref = pallas_kernel._step_update(
        tuple(jnp.asarray(s) for s in state),
        tuple(jnp.asarray(s) for s in scal), disk, adaptive,
    )
    got = trace_kernel.step_update(
        tuple(torch.from_numpy(s) for s in state),
        tuple(torch.from_numpy(s) for s in scal), disk, adaptive,
    )
    assert len(got) == trace_kernel.N_STATE == len(ref) == len(TOLERANCE)
    for slot, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == np.float32 == r.dtype, slot
        rtol, atol = TOLERANCE[slot]
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg=f"slot {slot}")
    # The step must exercise every decision it makes.
    res = got[trace_kernel.S_RESULT].numpy()
    codes = set(np.unique(res[state[trace_kernel.S_RESULT] == -1.0]))
    assert {-1.0, 0.0, 3.0} <= codes
    if disk:
        assert 1.0 in codes


# --- CPU twin of the CUDA source ----------------------------------------

_HOST_LOOP = r"""
#include "geodesic_step.cuh"
extern "C" void bh_trace_planes_host(const float* scal, const float* inp,
                                     float* out, long long n, int max_steps,
                                     int disk_on, int adaptive) {
  const bh::Scal s = bh::load_scal(scal);
  for (long long i = 0; i < n; ++i) {
    if (disk_on && adaptive)
      bh::trace_ray<true, true>(inp, out, n, i, s, max_steps);
    else if (disk_on)
      bh::trace_ray<true, false>(inp, out, n, i, s, max_steps);
    else if (adaptive)
      bh::trace_ray<false, true>(inp, out, n, i, s, max_steps);
    else
      bh::trace_ray<false, false>(inp, out, n, i, s, max_steps);
  }
}
"""


@pytest.fixture(scope="module")
def host_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CPU twin cannot be built")
    d = tmp_path_factory.mktemp("twin")
    src = d / "host_loop.cpp"
    src.write_text(_HOST_LOOP)
    lib_path = d / "libtwin.so"
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         f"-I{CSRC}", "-o", str(lib_path), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.bh_trace_planes_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bh_trace_planes_host.restype = None
    return lib


def _twin_case(integrator):
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    scene = Scene(
        BlackHole.create(1.0, 0.9), Disk.create(6.0, 20.0),
        SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                         max_steps=250, integrator=integrator),
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0)
    o, d = cam.generate_rays(camera, 32, 32)
    return (scene,) + trace_kernel.prepare(o, d, scene)


@pytest.mark.parametrize("integrator", ["rk4", "rkf45"])
@pytest.mark.parametrize("disk", [True, False], ids=["disk", "no-disk"])
def test_cuda_source_host_twin_matches_plain(host_twin, integrator, disk):
    """RK4: result codes and steps equal, every plane within 1e-4
    (positions up to 80 carry a few ulp of sqrt rounding: torch's CPU
    sqrt is not always correctly rounded, glibc's is).  RKF45: the
    parity contract, since the accept/reject cascade turns an ulp of
    log/exp rounding into another step sequence for near-critical rays:
    at most n/500 result codes differ, and the shaded colours of agreeing
    non-MAX_STEPS rays agree in mean (< 2e-3) and p99 (< 3e-2)."""
    adaptive = integrator == "rkf45"
    scene, scal, inp = _twin_case(integrator)
    n = inp.shape[1]
    plain = trace_kernel.trace_planes_plain(scal, inp, disk, 250, adaptive)
    twin = torch.empty((trace_kernel.N_OUT_PLANES, n), dtype=torch.float32)
    host_twin.bh_trace_planes_host(scal.data_ptr(), inp.data_ptr(),
                                   twin.data_ptr(), n, 250, int(disk),
                                   int(adaptive))
    if not adaptive:
        np.testing.assert_array_equal(twin[0].numpy(), plain[0].numpy())
        np.testing.assert_array_equal(twin[2].numpy(), plain[2].numpy())
        np.testing.assert_allclose(twin.numpy(), plain.numpy(), rtol=1e-4,
                                   atol=1e-4)
        return
    res_p, res_t = plain[0].numpy(), twin[0].numpy()
    agree = res_p == res_t
    assert np.sum(~agree) <= max(1, n // 500)
    scene = dataclasses.replace(scene, disk_enabled=disk)
    colors = [
        trace_kernel.postprocess(out, n, (n,), scene, None, inp[5]).color
        for out in (plain, twin)
    ]
    dc = (colors[0] - colors[1]).abs().amax(-1).numpy()
    dc = dc[agree & (res_p != trace_kernel.trace.ACTIVE)]  # MAX_STEPS
    assert dc.mean() < 2e-3 and np.percentile(dc, 99) < 3e-2
