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
import hashlib
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

# One intra-op thread for torch in these processes, which run XLA:CPU
# too.  With more, a process's first multi-threaded torch call after XLA
# had run came back wrong in the worker thread's share: in 2 of 40 fresh
# processes under a parallel test run, step_update's path length, chord
# direction and hit position differed on states 2048.. of 4096 (torch
# splits its vectorised sqrt into 2048-element chunks) by up to 4% of a
# chord, while a second call in the same process was right; none of 40
# processes with one thread, and none of 40 without XLA, went wrong.
torch.set_num_threads(1)

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
#include "dual.cuh"
extern "C" void bh_trace_planes_host(const float* scal, const float* inp,
                                     float* out, long long n, int max_steps,
                                     int disk_on, int adaptive, int track) {
  const bh::Scal s = bh::load_scal(scal);
  for (long long i = 0; i < n; ++i) {
    if (track && adaptive)
      bh::trace_ray<true, true, true>(inp, out, n, i, s, max_steps);
    else if (track)
      bh::trace_ray<true, false, true>(inp, out, n, i, s, max_steps);
    else if (disk_on && adaptive)
      bh::trace_ray<true, true>(inp, out, n, i, s, max_steps);
    else if (disk_on)
      bh::trace_ray<true, false>(inp, out, n, i, s, max_steps);
    else if (adaptive)
      bh::trace_ray<false, true>(inp, out, n, i, s, max_steps);
    else
      bh::trace_ray<false, false>(inp, out, n, i, s, max_steps);
  }
}

// K2 with one or two tangents (Dual<N>), as trace_fwdgrad.cu runs it.
template <typename F, int N>
void fwdgrad_rays_n(const float* scal, const float* dscal, const float* inp,
                    const float* dinp, float* out, long long n,
                    int max_steps, int disk_on, int adaptive, int track) {
  for (long long i = 0; i < n; ++i) {
#define BH_RAY(D, A, T)                                                    \
    bh::trace_ray_fwdgrad<N, D, A, T, F>(scal, dscal, inp, dinp, out, n, \
                                         i, max_steps)
    if (track && adaptive) BH_RAY(true, true, true);
    else if (track) BH_RAY(true, false, true);
    else if (disk_on && adaptive) BH_RAY(true, true, false);
    else if (disk_on) BH_RAY(true, false, false);
    else if (adaptive) BH_RAY(false, true, false);
    else BH_RAY(false, false, false);
#undef BH_RAY
  }
}

template <typename F>
void fwdgrad_rays(const float* scal, const float* dscal, const float* inp,
                  const float* dinp, float* out, long long n, int max_steps,
                  int disk_on, int adaptive, int n_tan, int track) {
  if (n_tan == 1)
    fwdgrad_rays_n<F, 1>(scal, dscal, inp, dinp, out, n, max_steps, disk_on,
                         adaptive, track);
  else
    fwdgrad_rays_n<F, 2>(scal, dscal, inp, dinp, out, n, max_steps, disk_on,
                         adaptive, track);
}

extern "C" void bh_trace_planes_fwdgrad_host(
    const float* scal, const float* dscal, const float* inp,
    const float* dinp, float* out, long long n, int max_steps, int disk_on,
    int adaptive, int n_tan, int track) {
  fwdgrad_rays<float>(scal, dscal, inp, dinp, out, n, max_steps, disk_on,
                      adaptive, n_tan, track);
}

// Dual<2>'s quotients elementwise: kind 0 a / b, 1 a / b with a a float
// (its tangents unused), 2 a / b with b a float; da, db, dq are (2, n).
extern "C" void bh_dual_div(int kind, const float* a, const float* da,
                            const float* b, const float* db, float* q,
                            float* dq, long long n) {
  using D = bh::Dual<2>;
  for (long long i = 0; i < n; ++i) {
    D x(a[i]), y(b[i]);
    for (int j = 0; j < 2; ++j) {
      x.d[j] = da[j * n + i];
      y.d[j] = db[j * n + i];
    }
    const D r = kind == 0 ? x / y : kind == 1 ? a[i] / y : x / b[i];
    q[i] = r.v;
    for (int j = 0; j < 2; ++j) dq[j * n + i] = r.d[j];
  }
}

// The tangent guard on Dual<2> states: v (NS, n) the slots' primal, d
// (2, NS, n) their tangents, guarded in place.
template <bool TRACK>
void dual_guard(const float* v, float* d, long long n) {
  constexpr int NS = bh::n_state(TRACK);
  for (long long i = 0; i < n; ++i) {
    bh::StateT<bh::Dual<2>, TRACK> S;
    bh::Dual<2>* slot[NS];
    bh::state_slots(S, slot);
    for (int k = 0; k < NS; ++k) {
      slot[k]->v = v[k * n + i];
      for (int j = 0; j < 2; ++j) slot[k]->d[j] = d[(j * NS + k) * n + i];
    }
    bh::guard(S);
    for (int k = 0; k < NS; ++k)
      for (int j = 0; j < 2; ++j) d[(j * NS + k) * n + i] = slot[k]->d[j];
  }
}
extern "C" void bh_dual_guard(const float* v, float* d, long long n,
                              int track) {
  if (track)
    dual_guard<true>(v, d, n);
  else
    dual_guard<false>(v, d, n);
}

// A float that counts the floating-point operations the kernels' source
// performs on it: +, -, *, / and max/min one each, sqrt, log and exp one,
// the renormalisation's 1 / sqrt two; negation, abs and comparisons none.
// An FMA is a multiply and an add here: two.  It also tallies the IEEE
// divisions (the renormalisation's 1 / sqrt included) and square roots
// (rsqrt included): each costs several instructions on the card.
// `excess` counts the operations that the source's forms spend beyond the
// least the same arithmetic needs (the least reads the same whatever
// form implements it): 1 / sqrt is one rsqrt; a Dual quotient spends a
// reciprocal of the divisor where the quotient rule q' = (a' - q b') / b
// takes three per tangent; float / Dual spends that reciprocal too where
// k = q / b and one product per tangent do; a Dual max/min takes a
// weighted sum of the tangents where a select does (the weights differ
// from 0 and 1 only at a tie).  The tangent guard skips its rescale where
// it is the identity: that rescale (a max, a division and a product per
// slot) counts in the least all the same, as negative excess.
namespace cnt {
long long flops = 0;
long long excess = 0;
long long divs = 0;
long long sqrts = 0;
struct Flop {
  float v;
  Flop() {}
  Flop(float x) : v(x) {}
};
inline Flop op(float x) { ++flops; return Flop(x); }
#define BH_ARITH(OP)                                                       \
  inline Flop operator OP(Flop a, Flop b) { return op(a.v OP b.v); }      \
  inline Flop operator OP(Flop a, float b) { return op(a.v OP b); }       \
  inline Flop operator OP(float a, Flop b) { return op(a OP b.v); }
BH_ARITH(+)
BH_ARITH(-)
BH_ARITH(*)
#undef BH_ARITH
inline Flop operator/(Flop a, Flop b) { ++divs; return op(a.v / b.v); }
inline Flop operator/(Flop a, float b) { ++divs; return op(a.v / b); }
inline Flop operator/(float a, Flop b) { ++divs; return op(a / b.v); }
#define BH_CMP(OP)                                                         \
  inline bool operator OP(Flop a, Flop b) { return a.v OP b.v; }          \
  inline bool operator OP(Flop a, float b) { return a.v OP b; }
BH_CMP(<)
BH_CMP(<=)
BH_CMP(>)
BH_CMP(>=)
BH_CMP(==)
#undef BH_CMP
inline Flop operator-(Flop a) { return Flop(-a.v); }
inline Flop sqrt_(Flop a) { ++sqrts; return op(sqrtf(a.v)); }
inline Flop rsqrt_(Flop a) {
  ++flops;
  ++excess;
  ++sqrts;
  ++divs;
  return op(1.0f / sqrtf(a.v));
}
inline Flop log_(Flop a) { return op(logf(a.v)); }
inline Flop exp_(Flop a) { return op(expf(a.v)); }
inline Flop abs_(Flop a) { return Flop(fabsf(a.v)); }
inline Flop jmax(Flop a, Flop b) { return op(bh::jmax(a.v, b.v)); }
inline Flop jmin(Flop a, Flop b) { return op(bh::jmin(a.v, b.v)); }
inline Flop jmax(Flop a, float b) { return op(bh::jmax(a.v, b)); }
inline Flop jmin(Flop a, float b) { return op(bh::jmin(a.v, b)); }
inline bool is_finite(Flop a) { return bh::is_finite(a.v); }
inline float val(Flop a) { return a.v; }
inline void slave_trig(Flop&, Flop&, Flop&, Flop&, Flop, Flop) {}

// The Dual forms on the counting type, found by argument-dependent lookup
// before dual.cuh's generic ones: each adds its excess and runs dual.cuh's.
template <int N>
using D = bh::Dual<N, Flop>;
template <int N>
D<N> operator/(const D<N>& a, const D<N>& b) {
  excess += 1;
  return bh::operator/(a, b);
}
template <int N>
D<N> operator/(float c, const D<N>& b) {
  excess += 1;
  return bh::operator/(c, b);
}
template <int N>
D<N> jmax(const D<N>& a, const D<N>& b) {
  excess += 3 * N;
  return bh::jmax(a, b);
}
template <int N>
D<N> jmin(const D<N>& a, const D<N>& b) {
  excess += 3 * N;
  return bh::jmin(a, b);
}
template <int N>
D<N> jmax(const D<N>& a, float c) {
  excess += N;
  return bh::jmax(a, c);
}
template <int N>
D<N> jmin(const D<N>& a, float c) {
  excess += N;
  return bh::jmin(a, c);
}
template <int N, bool TRACK>
void guard(bh::StateT<D<N>, TRACK>& S) {
  constexpr int NS = bh::n_state(TRACK);
  D<N>* slot[NS];
  bh::state_slots(S, slot);
  for (int i = 0; i < N; ++i) {
    float mag = fabsf(slot[0]->d[i].v);
    for (int k = 1; k < NS; ++k) mag = bh::jmax(mag, fabsf(slot[k]->d[i].v));
    if (mag <= bh::TANGENT_LIMIT) excess -= NS + 2;
  }
  bh::guard(S);
}
}  // namespace cnt

// K1's loop on the counting type; out: each ray's steps.
template <bool D, bool A, bool T>
void k1_count_ray(const float* scal, const float* inp, float* out,
                  long long n, long long i, int max_steps) {
  using cnt::Flop;
  constexpr int NS = bh::n_state(T);
  bh::ScalT<Flop> s;
  Flop* sv[bh::N_SCAL];
  bh::scal_slots(s, sv);
  for (int k = 0; k < bh::N_SCAL; ++k) *sv[k] = Flop(scal[k]);
  bh::StateT<Flop, T> S;
  Flop* slot[NS];
  bh::state_slots(S, slot);
  float x[bh::N_INP], init[NS];
  for (int k = 0; k < bh::N_INP; ++k) x[k] = inp[k * n + i];
  bh::init_slots(x, scal[3], bh::ACTIVE, init);
  if constexpr (T) bh::init_track_slots(x, 1e9f, init + bh::N_STATE);
  for (int k = 0; k < NS; ++k) *slot[k] = Flop(init[k]);
  const Flop L(x[5]);
  bh::start_point(S, s);
  for (int it = 0; it < max_steps && S.result == bh::ACTIVE; ++it)
    bh::step_update<Flop, D, A, T>(S, L, s);
  out[i] = S.steps.v;
}

// Operations over whole traces: n_tan 0 counts K1 (out: (n,) steps),
// n_tan 1 or 2 counts K2 (out: ((1 + n_tan) P, n) planes).
extern "C" long long bh_count_flops(const float* scal, const float* dscal,
                                    const float* inp, const float* dinp,
                                    float* out, long long n, int max_steps,
                                    int disk_on, int adaptive, int n_tan,
                                    int track) {
  cnt::flops = cnt::excess = cnt::divs = cnt::sqrts = 0;
  if (n_tan == 0) {
#define BH_RAY(D, A, T) k1_count_ray<D, A, T>(scal, inp, out, n, i, max_steps)
    for (long long i = 0; i < n; ++i) {
      if (track && adaptive) BH_RAY(true, true, true);
      else if (track) BH_RAY(true, false, true);
      else if (disk_on && adaptive) BH_RAY(true, true, false);
      else if (disk_on) BH_RAY(true, false, false);
      else if (adaptive) BH_RAY(false, true, false);
      else BH_RAY(false, false, false);
    }
#undef BH_RAY
  } else {
    fwdgrad_rays<cnt::Flop>(scal, dscal, inp, dinp, out, n, max_steps,
                            disk_on, adaptive, n_tan, track);
  }
  return cnt::flops;
}

// The excess, divisions and square roots (see cnt) of the last
// bh_count_flops.
extern "C" long long bh_count_excess() { return cnt::excess; }
extern "C" long long bh_count_divs() { return cnt::divs; }
extern "C" long long bh_count_sqrts() { return cnt::sqrts; }
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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bh_trace_planes_host.restype = None
    lib.bh_trace_planes_fwdgrad_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bh_trace_planes_fwdgrad_host.restype = None
    lib.bh_dual_div.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong]
    lib.bh_dual_div.restype = None
    lib.bh_dual_guard.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int]
    lib.bh_dual_guard.restype = None
    lib.bh_count_flops.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bh_count_flops.restype = ctypes.c_longlong
    for fn in (lib.bh_count_excess, lib.bh_count_divs, lib.bh_count_sqrts):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    return lib


def _twin_case(integrator, softness=0.0):
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    scene = Scene(
        BlackHole.create(1.0, 0.9, device="cpu"),
        Disk.create(6.0, 20.0, device="cpu"),
        SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                         max_steps=250, integrator=integrator,
                         shadow_softness=softness, device="cpu"),
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, device="cpu")
    o, d = cam.generate_rays(camera, 32, 32)
    return (scene,) + trace_kernel.prepare(o, d, scene)


@pytest.mark.parametrize("integrator", ["rk4", "rkf45"])
@pytest.mark.parametrize("disk,track", [(True, False), (False, False),
                                        (True, True)],
                         ids=["disk", "no-disk", "disk-track"])
def test_cuda_source_host_twin_matches_plain(host_twin, integrator, disk,
                                             track):
    """RK4: result codes and steps equal, every plane within 1e-4
    (positions up to 80 carry a few ulp of sqrt rounding: torch's CPU
    sqrt is not always correctly rounded, glibc's is).  RKF45: the
    parity contract, since the accept/reject cascade turns an ulp of
    log/exp rounding into another step sequence for near-critical rays:
    at most n/500 result codes differ, and the shaded colours of agreeing
    non-MAX_STEPS rays agree in mean (< 2e-3) and p99 (< 3e-2).  track:
    the TRACK build's 22 planes (softness 0.3 for the shading), whose
    tracking planes are live on rays on both sides of the disk plane."""
    adaptive = integrator == "rkf45"
    scene, scal, inp = _twin_case(integrator, 0.3 if track else 0.0)
    n = inp.shape[1]
    plain = trace_kernel.trace_planes_plain(scal, inp, disk, 250, adaptive,
                                            track)
    twin = torch.empty((trace_kernel.n_out(track), n), dtype=torch.float32)
    host_twin.bh_trace_planes_host(scal.data_ptr(), inp.data_ptr(),
                                   twin.data_ptr(), n, 250, int(disk),
                                   int(adaptive), int(track))
    if track:
        tracked = plain[15] < 1e9
        assert bool((tracked & (plain[18] > 0)).any())
        assert bool((tracked & (plain[18] < 0)).any())
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


# --- CPU twin of the multi-tangent kernel (Dual<2>) ----------------------


def _fwdgrad_case(integrator, disk, size=16, time_step=0.5, max_steps=80,
                  max_dist=40.0, softness=0.0):
    """The parity camera's rays at the wide step and a path budget of 40
    (rays retire within 80 steps on the disk or the budget), with the
    tangents d/dmass and d/dspin of prepare's planes."""
    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.render import camera as cam

    cpu = dict(device="cpu")
    scene = Scene(
        BlackHole.create(1.0, 0.9, **cpu), Disk.create(6.0, 20.0, **cpu),
        SimConfig.create(time_step=time_step, max_ray_distance=max_dist,
                         max_steps=max_steps, integrator=integrator,
                         shadow_softness=softness, **cpu),
        disk_enabled=disk,
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, **cpu)
    o, d = cam.generate_rays(camera, size, size)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()

    def pre(m, a):
        return trace_kernel.prepare(o, d, dataclasses.replace(
            scene, blackhole=dataclasses.replace(scene.blackhole, mass=m,
                                                 spin=a)))

    m0, a0 = scene.blackhole.mass, scene.blackhole.spin
    scal, inp = pre(m0, a0)
    tangents = [torch.func.jvp(pre, (m0, a0), (torch.tensor(float(k == 0)),
                                               torch.tensor(float(k == 1))))[1]
                for k in range(2)]
    dscal = torch.stack([t[0] for t in tangents]).float().contiguous()
    dinp = torch.stack([t[1] for t in tangents]).contiguous()
    return scene, scal, dscal, inp, dinp, max_steps


@pytest.mark.parametrize("integrator,disk,track",
                         [("rk4", True, False), ("rk4", False, False),
                          ("rkf45", True, False), ("rk4", True, True),
                          ("rkf45", True, True)],
                         ids=["rk4-disk", "rk4-no-disk", "rkf45-disk",
                              "rk4-disk-track", "rkf45-disk-track"])
def test_dual_host_twin_matches_plain(host_twin, integrator, disk, track):
    """csrc's trace_ray_fwdgrad on Dual<2> (g++, no FMA) against
    trace_planes_fwdgrad_plain.  RK4: result codes and steps equal; the
    tangent planes within 1e-4 (|plain| + the largest |plain| of their
    kind: lengths and positions, or unit directions and trig): the
    Dual follows jax.jvp's product and quotient rules and torch its own,
    a few ulp per operation (measured 2e-5).  RKF45: the distribution
    contract on the primal, as for the forward kernel: the
    accept/reject cascade turns an ulp of log/exp into another step
    sequence.  track: the TRACK build with its 22 planes per set, min_az
    with the lengths, the tracked position and direction with theirs;
    under RKF45 the colours are compared on the rays whose step counts
    agree too, since min_az is a minimum over the sampled points and
    another step sequence samples others (at this wide step a ray one
    step apart moves its min_az by up to 0.8: measured colour gaps up to
    0.56 on 2 of 256 rays)."""
    adaptive = integrator == "rkf45"
    scene, scal, dscal, inp, dinp, steps = _fwdgrad_case(
        integrator, disk, softness=0.3 if track else 0.0)
    n = inp.shape[1]
    p = trace_kernel.n_out(track)
    out_p, dout_p = trace_kernel.trace_planes_fwdgrad_plain(
        scal, dscal, inp, dinp, disk, steps, adaptive, track)
    twin = torch.empty((3 * p, n))
    host_twin.bh_trace_planes_fwdgrad_host(
        scal.data_ptr(), dscal.data_ptr(), inp.data_ptr(), dinp.data_ptr(),
        twin.data_ptr(), n, steps, int(disk), int(adaptive), 2, int(track))
    out_t, dout_t = twin[:p], twin[p:].view(2, p, n)
    codes = set(out_p[0].tolist())
    if track:
        assert bool((out_p[15] < 1e9).any())
    if not adaptive:
        assert 3.0 in codes and (1.0 in codes) == disk
        np.testing.assert_array_equal(out_t[0].numpy(), out_p[0].numpy())
        np.testing.assert_array_equal(out_t[2].numpy(), out_p[2].numpy())
        np.testing.assert_allclose(out_t.numpy(), out_p.numpy(), rtol=1e-4,
                                   atol=1e-4)
        lengths = [1, 3, 4, 5, 9, 14] + ([15, 16, 17, 18] if track else [])
        units = [6, 7, 8, 10, 11, 12, 13] + ([19, 20, 21] if track else [])
        for k in range(2):
            for planes in (lengths, units):
                t, p = dout_t[k][planes].numpy(), dout_p[k][planes].numpy()
                bound = 1e-4 * (np.abs(p) + np.abs(p).max())
                assert np.all(np.abs(t - p) <= bound), (k, planes)
        return
    res_p, res_t = out_p[0].numpy(), out_t[0].numpy()
    agree = res_p == res_t
    assert np.sum(~agree) <= max(1, n // 500)
    colors = [trace_kernel.postprocess(out, n, (n,), scene, None, inp[5]).color
              for out in (out_p, out_t)]
    dc = (colors[0] - colors[1]).abs().amax(-1).numpy()
    if track:
        agree &= out_p[2].numpy() == out_t[2].numpy()
    dc = dc[agree & (res_p != trace_kernel.trace.ACTIVE)]
    assert dc.mean() < 2e-3 and np.percentile(dc, 99) < 3e-2


def count_per_step(host_twin, n_tan, adaptive, track):
    """Per step of a kernel variant with the disk on, over the 8x8 parity
    camera's rays at 250 steps: (least, executed) operations and (IEEE
    divisions, square roots)."""
    _, scal, dscal, inp, dinp, _ = _fwdgrad_case(
        "rkf45" if adaptive else "rk4", True, size=8, time_step=0.1,
        max_steps=250, max_dist=80.0)
    n = inp.shape[1]
    p = trace_kernel.n_out(track)
    out = torch.empty(n if n_tan == 0 else (1 + n_tan) * p * n)
    flops = host_twin.bh_count_flops(
        scal.data_ptr(), dscal.data_ptr(), inp.data_ptr(), dinp.data_ptr(),
        out.data_ptr(), n, 250, 1, int(adaptive), n_tan, int(track))
    least = flops - host_twin.bh_count_excess()
    steps = float((out if n_tan == 0 else out.view(-1, n)[2]).double().sum())
    return ((least / steps, flops / steps),
            (host_twin.bh_count_divs() / steps,
             host_twin.bh_count_sqrts() / steps))


def test_flops_per_step_match_chip_smoke(host_twin):
    """The floating-point operations per step of each kernel variant on
    the bench's path and the soft path (track), counted by running
    csrc's code on a counting float (an FMA counts 2), match the
    constants chip_smoke.py computes its bounds and issue shares from
    (within 0.5%: the count per step varies with the branches a ray
    takes): the least the arithmetic needs, and what the source
    executes."""
    import chip_smoke

    for track in (False, True):
        for adaptive in (False, True):
            for n_tan in (0, 1, 2):
                got = count_per_step(host_twin, n_tan, adaptive, track)[0]
                refs = chip_smoke.FLOPS_PER_STEP[(n_tan, adaptive, track)]
                for g, ref in zip(got, refs):
                    assert abs(g / ref - 1.0) < 5e-3, (n_tan, adaptive,
                                                       track, g)


_VARIANTS = [(n_tan, adaptive, track) for track in (False, True)
             for adaptive in (False, True) for n_tan in (0, 1, 2)]


@pytest.mark.parametrize(
    "n_tan,adaptive,track", _VARIANTS,
    ids=[f"n{n}-{'rkf45' if a else 'rk4'}{'-track' if t else ''}"
         for n, a, t in _VARIANTS])
def test_divisions_per_step_match_chip_smoke(host_twin, n_tan, adaptive,
                                             track):
    """The IEEE divisions (1 / sqrt included) and square roots (rsqrt
    included) per step of each kernel variant, counted on the counting
    float, match chip_smoke.DIVS_PER_STEP (within 0.5%, as the operation
    counts).  K2's quotients take one reciprocal of the divisor (2
    divisions whatever the tangents, where jax.jvp's literal rule spends
    2 + n), and its guard divides only where it rescales."""
    import chip_smoke

    got = count_per_step(host_twin, n_tan, adaptive, track)[1]
    ref = chip_smoke.DIVS_PER_STEP[(n_tan, adaptive, track)]
    for g, r in zip(got, ref):
        assert abs(g / r - 1.0) < 5e-3, (g, r)


_PRIMAL_VARIANTS = [(integ, disk, track, n_tan)
                    for integ in ("rk4", "rkf45")
                    for disk, track in ((True, False), (False, False),
                                        (True, True))
                    for n_tan in (1, 2)]


@pytest.mark.parametrize(
    "integrator,disk,track,n_tan", _PRIMAL_VARIANTS,
    ids=[f"{i}-{'disk' if d else 'no-disk'}{'-track' if t else ''}-n{n}"
         for i, d, t, n in _PRIMAL_VARIANTS])
def test_dual_primal_equals_float_twin(host_twin, integrator, disk, track,
                                       n_tan):
    """K2's primal is K1's: the g++ Dual<n> twin's primal planes are
    bitwise the float twin's (-ffp-contract=off) over whole traces of
    the parity camera's rays (the wide-step case: they retire), every
    disk, integrator and track variant; the Dual forms (one reciprocal
    per quotient, the guard that skips its identity rescale) touch only
    the tangents."""
    adaptive = integrator == "rkf45"
    _, scal, dscal, inp, dinp, steps = _fwdgrad_case(integrator, disk)
    n = inp.shape[1]
    p = trace_kernel.n_out(track)
    k1 = torch.empty((p, n))
    host_twin.bh_trace_planes_host(scal.data_ptr(), inp.data_ptr(),
                                   k1.data_ptr(), n, steps, int(disk),
                                   int(adaptive), int(track))
    dscal, dinp = dscal[:n_tan].contiguous(), dinp[:n_tan].contiguous()
    k2 = torch.empty(((1 + n_tan) * p, n))
    host_twin.bh_trace_planes_fwdgrad_host(
        scal.data_ptr(), dscal.data_ptr(), inp.data_ptr(), dinp.data_ptr(),
        k2.data_ptr(), n, steps, int(disk), int(adaptive), n_tan, int(track))
    assert len(set(k1[0].tolist())) >= 2
    np.testing.assert_array_equal(k2[:p].numpy(), k1.numpy())
    assert bool(torch.isfinite(k2[p:]).all())


# Dual's quotient forms against jax.jvp's rules (d(x/y) = dx/y +
# (-dy x) y^-2; d(c/y) = (-dy c) y^-2; d(x/c) = dx/c).  Both round each
# intermediate once (4 to 5 roundings per tangent), so they may differ by
# a few ulp of the terms' magnitude |dx/y| + |x dy/y^2|: held to
# DIV_RTOL, 4 float32 ulp (measured 2.1, 2.0 and 1.0 ulp for a/b, c/b
# and a/c on these inputs).
DIV_RTOL = 4 * 2.0 ** -23


@pytest.mark.parametrize("kind", ["a/b", "c/b", "a/c"])
def test_dual_quotients_match_jax(host_twin, kind):
    """Dual<2>'s quotients (one reciprocal of the divisor per quotient)
    against jax.jvp of the same division on numpy-seeded float32 inputs,
    divisors of both signs from 1e-15 to 1e4: the primal bitwise, each
    tangent within DIV_RTOL of its terms' magnitude."""
    import jax

    rng = np.random.default_rng(41)
    n = 4096
    f = np.float32
    a = rng.normal(0, 10.0, n).astype(f)
    b = (rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-15, 4, n)).astype(f)
    da = rng.normal(0, 3.0, (2, n)).astype(f)
    db = rng.normal(0, 3.0, (2, n)).astype(f)
    q = np.empty(n, f)
    dq = np.empty((2, n), f)
    host_twin.bh_dual_div(["a/b", "c/b", "a/c"].index(kind), a.ctypes.data,
                          da.ctypes.data, b.ctypes.data, db.ctypes.data,
                          q.ctypes.data, dq.ctypes.data, n)
    a_, b_ = jnp.asarray(a), jnp.asarray(b)
    for j in range(2):
        if kind == "a/b":
            prim, ref = jax.jvp(lambda x, y: x / y, (a_, b_),
                                (jnp.asarray(da[j]), jnp.asarray(db[j])))
        elif kind == "c/b":
            prim, ref = jax.jvp(lambda y: a_ / y, (b_,), (jnp.asarray(db[j]),))
        else:
            prim, ref = jax.jvp(lambda x: x / b_, (a_,), (jnp.asarray(da[j]),))
        np.testing.assert_array_equal(q, np.asarray(prim))
        ad = np.float64(da[j]) if kind != "c/b" else 0.0
        bd = np.float64(db[j]) if kind != "a/c" else 0.0
        scale = (np.abs(ad / np.float64(b))
                 + np.abs(np.float64(a) * bd / np.float64(b) ** 2))
        ref = np.asarray(ref, np.float64)
        assert np.all(np.isfinite(ref)) and np.all(np.isfinite(dq[j]))
        assert np.all(np.abs(dq[j] - ref) <= DIV_RTOL * scale), (
            kind, j, float(np.max(np.abs(dq[j] - ref) / scale)))


@pytest.mark.parametrize("track", [False, True], ids=["state", "track"])
def test_dual_guard_matches_jax(host_twin, track):
    """The Dual tangent guard, which skips its rescale where it is the
    identity, against jax.jvp of sensitivity.tangent_guard over the same
    slots, bitwise, per tangent direction: rays under the limit (most),
    at it, over it (a rescale), and with a NaN or an infinity (zeroed)."""
    import jax

    from blackhole_tpu.integrate import sensitivity as jsens

    ns = trace_kernel.N_STATE + (trace_kernel.N_TRACK if track else 0)
    n = 600
    rng = np.random.default_rng(29)
    v = rng.normal(0, 10.0, (ns, n)).astype(np.float32)
    d = rng.normal(0, 1e5, (2, ns, n)).astype(np.float32)
    d[0, 3, :40] = 3e7
    d[1, ns - 1, 40:60] = -5e6
    d[0, 7, 60:80] = np.nan
    d[1, 2, 80:100] = np.inf
    d[:, 5, 100:120] = 1e6
    got = d.copy()
    host_twin.bh_dual_guard(v.ctypes.data, got.ctypes.data, n, int(track))
    for j in range(2):
        _, ref = jax.jvp(lambda *t: jsens.tangent_guard(1, t),
                         tuple(jnp.asarray(x) for x in v),
                         tuple(jnp.asarray(x) for x in d[j]))
        np.testing.assert_array_equal(got[j], np.stack(
            [np.asarray(r) for r in ref]))
    assert np.array_equal(got[:, :, 120:], d[:, :, 120:])
    assert not np.array_equal(got[:, :, :100], d[:, :, :100])


# --- K1's planes held bitwise to the reference build --------------------

# The g++ twin's K1 output planes (see _HOST_LOOP), each plane's bytes
# hashed with SHA-256 (the first 16 hex digits), for the six K1 variants
# at the 64x64 parity cases (spin 0.9, 250 steps) and for the RKF45
# variants at chip_smoke.CONTROLLER_STATES, where every first step is
# rejected.  The values were made by building csrc/ as it stood at commit
# 18ff8ea (before the step carried its point across steps, computed the
# crossing point only on crossing steps and took one exp in the
# controller) into this twin with the same flags and running these cases:
# a change of the step's source that keeps every primal bit keeps them.
# Each entry: the SHA-256 of the inputs (scal, then inp; they come from
# torch's CPU functions, so a change there shows apart from the step's),
# then one digest per plane.  K1_BITS_RAYS (tests/k1_bits_rays.npz) holds
# one byte per ray of the same build, a hash over the ray's planes, so
# that a failure counts the rays that differ.
K1_PLANE_NAMES = ("result", "dist", "steps", "hx", "hy", "hz", "lx", "ly",
                  "lz", "r", "sth", "cth", "sph", "cph", "min_r", "min_az",
                  "gx", "gy", "gz", "gdx", "gdy", "gdz")
K1_BITS = {
    "parity-rk4-disk": (
        "5c018a451ebf77e1 ceabc97dee2153cc 843e65a73cd1ed04 cdd9e4e5cfb793b4 "
        "bb03dc620a9ac614 584a0b368c756c49 5def877352c26bd6 27787f1a1245378a "
        "5e8cc8018167e114 6745ec7149402ab5 ab2b969b1e5e790e 5904eee3757a30bb "
        "89a37ed5ec3c4548 f3946448300f8dd4 7c210e2dcaff98c0 77c7824667ccef0b"
    ),
    "parity-rk4-no-disk": (
        "5c018a451ebf77e1 969dff138e727074 8f44dfd01db9d96d d770fd6151d55989 "
        "4fe7b59af6de3b66 22337129a84cb448 dee6e5303db9f9c2 c4d091878b062a26 "
        "4e9655caaa714855 259ded7c38ec36f7 d3927a97528a6167 55c5b04cadee686c "
        "f454dbe56a9a8e5d 432838edc6a05b2d 85dc52fa82fb73cb a7d5e045c0ef773b"
    ),
    "parity-rk4-disk-track": (
        "5c018a451ebf77e1 ceabc97dee2153cc 843e65a73cd1ed04 cdd9e4e5cfb793b4 "
        "bb03dc620a9ac614 584a0b368c756c49 5def877352c26bd6 27787f1a1245378a "
        "5e8cc8018167e114 6745ec7149402ab5 ab2b969b1e5e790e 5904eee3757a30bb "
        "89a37ed5ec3c4548 f3946448300f8dd4 7c210e2dcaff98c0 77c7824667ccef0b "
        "bcc504f118b8d872 63563bdf7b3f4050 70d8697d4842b4ba 57ea67927d77cb06 "
        "b767136b4808c767 0ca67276d17b4f9c 2c3ba52dfd3302ea"
    ),
    "parity-rkf45-disk": (
        "5c018a451ebf77e1 2eee78fff86fa3d5 8a6fafa4ed60d086 4dd14a22a2b0ebee "
        "de8d13396762b091 266438df07618f22 c7f445d285524b5c fd58602f2229d61c "
        "395be5ba717b9db6 ebfad5d0b57c7cfe 2ab3f04604d83f0c acea2a94878c94e3 "
        "3323fe820d3987bb 78a915ed0fe74f8e 459a18a48c542540 6068135d3dc4d6d9"
    ),
    "parity-rkf45-no-disk": (
        "5c018a451ebf77e1 66ceeee0bedefb13 c639f13daf18b758 6520dd556b46036a "
        "b0d86ee77f0ae14e d0157523cc71f53d 7b46e1cd7d09c2be 139b35682000758d "
        "c22f1a63b3f060bb 2ebf1980918bbc5b 79c4d9f527e0c1c2 1916948f5c370e55 "
        "4ca631b63dfa0cbd 04bb87106e1932b0 f531b1369d32fb4b 874d1a4cbe0afa4b"
    ),
    "parity-rkf45-disk-track": (
        "5c018a451ebf77e1 2eee78fff86fa3d5 8a6fafa4ed60d086 4dd14a22a2b0ebee "
        "de8d13396762b091 266438df07618f22 c7f445d285524b5c fd58602f2229d61c "
        "395be5ba717b9db6 ebfad5d0b57c7cfe 2ab3f04604d83f0c acea2a94878c94e3 "
        "3323fe820d3987bb 78a915ed0fe74f8e 459a18a48c542540 6068135d3dc4d6d9 "
        "3d49e251c39adfc0 fcddf179fd037de7 72c12b60e827c36b 39bda1d0112dc4d1 "
        "9ecba68cddaad22c 46f63659f8fa81d7 813c1da75ea61cfb"
    ),
    "clamped-rkf45-disk": (
        "0500b337c10f2f42 4409efd063a28f93 8efa88128c41b973 bd2de8ee4163b73b "
        "cb80a6610376a371 e751f10b358a14a5 c94a37329f6a8d8f e71d78262d7a5a3c "
        "84ad3109a4eb3f98 d6436f62955d16bc 0b5234c32df610b4 7a60dc5ef5032e50 "
        "fadf02013fa1d3f6 fa274681163cc001 13c6d2bb592cbae9 c0bf3717480d817e"
    ),
    "clamped-rkf45-no-disk": (
        "0500b337c10f2f42 b120ab275a4bd002 82b0ad6cc9f65aa3 8edc3b57c11e1b10 "
        "a7c1729f1f4c926d 088310577c50ba9b f56f4cbc9675fd2a 9757d631a29c86ce "
        "f21cd9342794d800 27c8aea90931d839 cca6a8d67551265a 201c3c75b2fb8a44 "
        "985fb915510311ad 1666db9117f7ab47 3a7298883a069855 53049f1ed206f913"
    ),
    "clamped-rkf45-disk-track": (
        "0500b337c10f2f42 4409efd063a28f93 8efa88128c41b973 bd2de8ee4163b73b "
        "cb80a6610376a371 e751f10b358a14a5 c94a37329f6a8d8f e71d78262d7a5a3c "
        "84ad3109a4eb3f98 d6436f62955d16bc 0b5234c32df610b4 7a60dc5ef5032e50 "
        "fadf02013fa1d3f6 fa274681163cc001 13c6d2bb592cbae9 c0bf3717480d817e "
        "d9aa7dc9b21db633 4d66b1590452ce37 55a2a14cbb5b4bda fbdc2264c0f99b67 "
        "1a2c1a00c3ba2af0 b8023eaf08af7c33 b0482ec348a15554"
    ),
    "rejected-rkf45-disk": (
        "f16768dca7079ed3 9dfb9ba478efd19d 2785a2d53776d17a c1c7a2a41da82566 "
        "d412a69c7efecf69 aa7ca2fde48d877c 8765e1481bc8c8d3 527e900c35a14505 "
        "971daffa360dd9f4 15f67bc45c85c88c c96aa5995aad9bd5 3df22307f7ba55a6 "
        "0a3106746d2a5af7 6a7ff136e2aa3ecd 86bf96de21e378de 93812425c2259977"
    ),
    "rejected-rkf45-no-disk": (
        "f16768dca7079ed3 5e4c92bab0a37f79 048808cfb4d97a3f 0d0cd5d40accf512 "
        "8493d63458f75bba 6da52ca8f115fa3b c120f6ae7aec6670 551a85e876be81e0 "
        "d94d43f170d72643 21f27de7eebe0369 dd77f9b0c70c37f5 e4b9fba4209f5a01 "
        "21c6534a59232944 6cb89bf9f1f0dfae 0b3942de41262a96 1c096d5b850087e8"
    ),
    "rejected-rkf45-disk-track": (
        "f16768dca7079ed3 9dfb9ba478efd19d 2785a2d53776d17a c1c7a2a41da82566 "
        "d412a69c7efecf69 aa7ca2fde48d877c 8765e1481bc8c8d3 527e900c35a14505 "
        "971daffa360dd9f4 15f67bc45c85c88c c96aa5995aad9bd5 3df22307f7ba55a6 "
        "0a3106746d2a5af7 6a7ff136e2aa3ecd 86bf96de21e378de 93812425c2259977 "
        "c30a288c641a7b5b 91dee33c79f2eb39 870ca1e61fc03de2 c508b2ee7471e30f "
        "979374d026f7a8b5 139a5a3661a6d77c 614743cff7f8c71f"
    ),
}
K1_BITS_RAYS = Path(__file__).resolve().parent / "k1_bits_rays.npz"

_BITS_CASES = ([("parity", i, d, t) for i in ("rk4", "rkf45")
                for d, t in ((True, False), (False, False), (True, True))]
               + [(c, "rkf45", d, t) for c in ("clamped", "rejected")
                  for d, t in ((True, False), (False, False), (True, True))])


def _bits_id(states, integrator, disk, track):
    return (f"{states}-{integrator}-{'disk' if disk else 'no-disk'}"
            f"{'-track' if track else ''}")


def _bits_inputs(states, integrator, disk, track):
    """(scal, inp, planes_args) of a bits case: the parity case of
    chip_smoke.parity_scene at 64x64, or its controller states
    (chip_smoke.controller_scene; disk off by replacing the scene's)."""
    import chip_smoke

    if states == "parity":
        scene, _, o, d = chip_smoke.parity_scene(
            0.9, disk, integrator, "cpu", 64, softness=0.3 if track else 0.0)
    else:
        scene, o, d = chip_smoke.controller_scene("cpu", 64, track, states)
        scene = dataclasses.replace(scene, disk_enabled=disk)
    scal, inp = trace_kernel.prepare(o, d, scene)
    return scal, inp, trace_kernel.planes_args(scene)


def _k1_twin_planes(lib, scal, inp, args):
    """The twin's K1 planes (n_out, n) for prepared inputs."""
    disk, max_steps, adaptive, track = args
    n = inp.shape[1]
    out = torch.empty((trace_kernel.n_out(track), n), dtype=torch.float32)
    lib.bh_trace_planes_host(scal.data_ptr(), inp.data_ptr(), out.data_ptr(),
                             n, max_steps, int(disk), int(adaptive),
                             int(track))
    return out


def _plane_digests(scal, inp, out):
    """[SHA-256 of the inputs, then of each plane], 16 hex digits each."""
    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    return [sha(scal, inp)] + [sha(p) for p in out]


def _ray_digests(out):
    """One byte per ray: FNV-1a over the bits of the ray's planes."""
    bits = out.contiguous().numpy().view(np.uint32).astype(np.uint64)
    h = np.full(bits.shape[1], 14695981039346656037, np.uint64)
    for row in bits:
        h = (h ^ row) * np.uint64(1099511628211)
    return (h >> np.uint64(56)).astype(np.uint8)


@pytest.mark.parametrize("case", _BITS_CASES,
                         ids=[_bits_id(*c) for c in _BITS_CASES])
def test_k1_twin_planes_bitwise_to_reference_build(host_twin, case):
    """Every K1 output plane of the twin, bitwise the reference build's
    (K1_BITS): the parity cases of all six variants and the RKF45
    variants at the controller states, whose first steps are rejected,
    so that the controller's rejected branch (its h and scale) is held
    without FMA noise.  A failure names the planes and counts the rays
    whose planes differ (one byte per ray: a difference may hide in 1 of
    256)."""
    key = _bits_id(*case)
    scal, inp, args = _bits_inputs(*case)
    out = _k1_twin_planes(host_twin, scal, inp, args)
    got = _plane_digests(scal, inp, out)
    want = K1_BITS[key].split()
    assert got[0] == want[0], (
        f"{key}: the inputs differ from those the digests were made from "
        f"(torch's CPU functions), not the step")
    bad = [K1_PLANE_NAMES[k] for k in range(len(got) - 1)
           if got[1 + k] != want[1 + k]]
    if bad:
        rays = np.load(K1_BITS_RAYS)[key]
        n_diff = int((_ray_digests(out) != rays).sum())
        pytest.fail(f"{key}: planes {bad} differ from the reference build's "
                    f"on at least {n_diff} of {out.shape[1]} rays")


# --- the Dual<2> twin at the controller states -----------------------------


@pytest.mark.parametrize("track", [False, True], ids=["disk", "disk-track"])
@pytest.mark.parametrize("states", ["clamped", "rejected"])
def test_dual_twin_at_controller_states_matches_plain(host_twin, states,
                                                      track):
    """csrc's K2 step on Dual<2> (g++, no FMA) after 2 steps from
    chip_smoke.CONTROLLER_STATES (RKF45, every first step rejected)
    against step_update_jvp (trace_planes_fwdgrad_plain), d/d(mass, spin),
    under chip_smoke's one-step contract (phase 5b): codes and step
    counts equal; the median gap of the planes and of their tangents
    within ONE_STEP_TOL, the last chord direction's within
    ONE_STEP_CHORD_TOL; per ray on the rays whose second step a clamp of
    the controller set (clamped_rays), which rounding cannot move.  At
    the "rejected" states the median holds the rejected branch's rule."""
    import chip_smoke

    scene, o, d = chip_smoke.controller_scene("cpu", 64, track, states)
    planes_in, _ = trace_kernel.prepare_fwdgrad(
        o, d, scene, chip_smoke.mass_spin_tangents(scene))
    scal, dscal, inp, dinp = planes_in
    disk, _, adaptive, trk = trace_kernel.planes_args(scene)
    args = (disk, 2, adaptive, trk)
    plain, dplain = trace_kernel.trace_planes_fwdgrad_plain(*planes_in, *args)
    n, p = inp.shape[1], trace_kernel.n_out(trk)
    twin = torch.empty((3 * p, n))
    host_twin.bh_trace_planes_fwdgrad_host(
        scal.data_ptr(), dscal.data_ptr(), inp.data_ptr(), dinp.data_ptr(),
        twin.data_ptr(), n, 2, int(disk), int(adaptive), 2, int(trk))
    out, dout = twin[:p], twin[p:].view(2, p, n)
    np.testing.assert_array_equal(out[0].numpy(), plain[0].numpy())
    np.testing.assert_array_equal(out[2].numpy(), plain[2].numpy())
    prim = torch.maximum(*chip_smoke.one_step_gaps(out, plain, trk))
    tan, chord = (torch.maximum(a, b) for a, b in zip(
        chip_smoke.one_step_gaps(dout[0], dplain[0], trk),
        chip_smoke.one_step_gaps(dout[1], dplain[1], trk)))
    first = trace_kernel.trace_planes_plain(scal, inp, disk, 1, adaptive,
                                            trk)
    held = chip_smoke.clamped_rays(o, d, scene, args, (plain, dplain), first)
    tol, chord_tol = chip_smoke.ONE_STEP_TOL, chip_smoke.ONE_STEP_CHORD_TOL
    assert int(held.sum()) > 0
    assert float(prim.median()) <= tol and float(tan.median()) <= tol
    assert float(chord.median()) <= chord_tol
    assert float(torch.maximum(prim, tan)[held].max()) <= tol
    assert float(chord[held].max()) <= chord_tol
