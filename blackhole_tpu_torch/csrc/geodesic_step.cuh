// One masked geodesic integration step, and the per-ray loop around it.
//
// Port of the loop body of the Pallas TPU kernels of
// blackhole_tpu/render/pallas_kernel.py (_step_update, _rhs, _cart,
// _load_init, _store_out), with their static `track` variant (the
// crossing-opacity planes of the soft boundary) as the compile-time
// parameter TRACK, written once for the CUDA kernels
// (trace_kernel.cu, trace_fwdgrad.cu) and for a host build with a plain C++
// compiler: BH_HD is __host__ __device__ under nvcc and plain inline
// otherwise.  Its plain PyTorch version is
// blackhole_tpu_torch/render/trace_kernel.py (step_update,
// trace_planes_plain, step_update_jvp); keep them in step.
//
// The step is a template over its scalar type T: float gives the forward
// kernel K1; Dual<N> (dual.cuh) gives the multi-tangent kernel K2, whose
// primal is computed by the same expressions and whose tangents follow
// jax.jvp's rules.  Every operation the templates need of T is an operator
// or one of the helpers below (sqrt_, rsqrt_, log_, exp_, abs_, jmax, jmin,
// jclip, is_finite, slave_trig, guard), overloaded for float here and for
// Dual in dual.cuh.
//
// Rounding follows the JAX package's float32 arithmetic: every constant
// is a float (a double quotient cast once, as JAX rounds a Python float),
// operations keep the reference's order, and the max/min helpers
// propagate NaN as jnp.maximum/jnp.minimum do (fmaxf/fminf drop it).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define BH_HD __host__ __device__ __forceinline__
#define BH_UNROLL _Pragma("unroll")
#else
#define BH_HD inline
#define BH_UNROLL
#endif

namespace bh {

constexpr int N_SCAL = 12;
constexpr int N_INP = 16;
constexpr int N_OUT = 15;
constexpr int N_STATE = 21;
// Crossing-opacity tracking: min |z'| in the disk's band, the position
// and the chord direction there; 7 more slots and output planes.
constexpr int N_TRACK = 7;
BH_HD constexpr int n_state(bool track) {
  return N_STATE + (track ? N_TRACK : 0);
}
BH_HD constexpr int n_out(bool track) { return N_OUT + (track ? N_TRACK : 0); }

constexpr float ACTIVE = -1.0f;
constexpr float HORIZON = 0.0f;
constexpr float DISK = 1.0f;
constexpr float BACKGROUND = 2.0f;
constexpr float MAX_DISTANCE = 3.0f;

constexpr float EPS = (float)1e-9;
constexpr float FLT_BIG = 3.40282346638528859812e+38f;

// RKF45 Fehlberg tableau (integrate/steppers.py), each rounded once.
constexpr float B21 = (float)(1.0 / 4.0);
constexpr float B31 = (float)(3.0 / 32.0), B32 = (float)(9.0 / 32.0);
constexpr float B41 = (float)(1932.0 / 2197.0);
constexpr float B42 = (float)(-7200.0 / 2197.0);
constexpr float B43 = (float)(7296.0 / 2197.0);
constexpr float B51 = (float)(439.0 / 216.0), B52 = -8.0f;
constexpr float B53 = (float)(3680.0 / 513.0);
constexpr float B54 = (float)(-845.0 / 4104.0);
constexpr float B61 = (float)(-8.0 / 27.0), B62 = 2.0f;
constexpr float B63 = (float)(-3544.0 / 2565.0);
constexpr float B64 = (float)(1859.0 / 4104.0);
constexpr float B65 = (float)(-11.0 / 40.0);
constexpr float C1 = (float)(25.0 / 216.0), C3 = (float)(1408.0 / 2565.0);
constexpr float C4 = (float)(2197.0 / 4104.0), C5 = (float)(-1.0 / 5.0);
constexpr float D1 = (float)(16.0 / 135.0), D3 = (float)(6656.0 / 12825.0);
constexpr float D4 = (float)(28561.0 / 56430.0), D5 = (float)(-9.0 / 50.0);
constexpr float D6 = (float)(2.0 / 55.0);
constexpr float SAFETY = 0.9f, MIN_SCALE = 0.2f, MAX_SCALE = 10.0f;

template <typename T>
struct ScalT {
  T M, a, Q, dt, max_dist, r_capture, disk_inner, disk_outer, sin_incl,
      cos_incl, tol, r_shell_min;
};
using Scal = ScalT<float>;

// The tracking slots exist only under TRACK: the empty base adds nothing
// to the state without it.
template <typename T, bool TRACK>
struct TrackSlotsT {};
template <typename T>
struct TrackSlotsT<T, true> {
  T min_az, gx, gy, gz, gdx, gdy, gdz;
};

// Whether the state carries its point's quasi-cartesian position from one
// step to the next (the previous point of the step's chord), where the
// step would otherwise recompute it: bitwise the value the last step
// computed for its new point.  Dual (dual.cuh) does not: its guard
// rescales the state's tangents after each step, and a carried point's
// tangents would miss that rescale.
template <typename T>
struct CarriesPoint {
  static constexpr bool value = true;
};
template <typename T, bool CARRY>
struct PointSlotsT {};
template <typename T>
struct PointSlotsT<T, true> {
  T cx, cy, cz;
};

// The 21 state slots of pallas_kernel._step_update, + 7 under TRACK (and
// the carried point, which is no slot).
template <typename T, bool TRACK = false>
struct StateT : TrackSlotsT<T, TRACK>,
                PointSlotsT<T, CarriesPoint<T>::value> {
  T r, th, ph, pr, pth, sth, cth, sph, cph;
  T dist, steps, result, hx, hy, hz, lx, ly, lz, t, h, min_r;
};
using State = StateT<float>;

// Pointers to the slots in the _S_* order (r .. cph, dist, steps, result,
// hx .. lz, t, h, min_r, then min_az, gx .. gdz under TRACK), and the slot
// of each output plane (the 15, then the 7 tracking slots in order).
template <typename T, bool TRACK>
BH_HD void state_slots(StateT<T, TRACK>& S, T* slot[]) {
  T* p[N_STATE] = {&S.r,    &S.th,    &S.ph,     &S.pr, &S.pth, &S.sth,
                   &S.cth,  &S.sph,   &S.cph,    &S.dist, &S.steps,
                   &S.result, &S.hx,  &S.hy,     &S.hz, &S.lx,  &S.ly,
                   &S.lz,   &S.t,     &S.h,      &S.min_r};
  for (int k = 0; k < N_STATE; ++k) slot[k] = p[k];
  if constexpr (TRACK) {
    T* q[N_TRACK] = {&S.min_az, &S.gx,  &S.gy, &S.gz,
                     &S.gdx,    &S.gdy, &S.gdz};
    for (int k = 0; k < N_TRACK; ++k) slot[N_STATE + k] = q[k];
  }
}
BH_HD int out_slot(int k) {
  const int slot[N_OUT] = {11, 9, 10, 12, 13, 14, 15, 16, 17,
                           0,  5, 6,  7,  8,  20};
  return slot[k];
}
BH_HD int out_slot_track(int k) {
  return k < N_OUT ? out_slot(k) : N_STATE + (k - N_OUT);
}

template <typename T>
BH_HD void scal_slots(ScalT<T>& s, T* slot[N_SCAL]) {
  T* p[N_SCAL] = {&s.M,          &s.a,          &s.Q,        &s.dt,
                  &s.max_dist,   &s.r_capture,  &s.disk_inner,
                  &s.disk_outer, &s.sin_incl,   &s.cos_incl, &s.tol,
                  &s.r_shell_min};
  for (int k = 0; k < N_SCAL; ++k) slot[k] = p[k];
}

// The 21 initial slot values from a ray's 16 input planes (the JAX
// package's _load_init): BL state and trig from the planes, hit position
// and last direction from the origin and direction, min_r = r0, h = h0;
// dist, steps and t start at 0, result at result0.  Fed a tangent's
// planes with result0 = 0 and h0 = d(time_step), it gives the initial
// tangent (_zero_ctrl_tangents).
BH_HD void init_slots(const float x[N_INP], float h0, float result0,
                      float init[N_STATE]) {
  const float v[N_STATE] = {x[0],  x[1],  x[2],  x[3],  x[4], x[12], x[13],
                            x[14], x[15], 0.0f,  0.0f,  result0, x[6], x[7],
                            x[8],  x[9],  x[10], x[11], 0.0f, h0,   x[0]};
  for (int k = 0; k < N_STATE; ++k) init[k] = v[k];
}
// The 7 initial tracking slots: min_az at min_az0 (1e9, or 0 for a
// tangent), the position and direction at the ray's origin and direction.
BH_HD void init_track_slots(const float x[N_INP], float min_az0,
                            float init[N_TRACK]) {
  const float v[N_TRACK] = {min_az0, x[6], x[7], x[8], x[9], x[10], x[11]};
  for (int k = 0; k < N_TRACK; ++k) init[k] = v[k];
}

// jnp.maximum / jnp.minimum / jnp.clip: NaN in either argument wins.
BH_HD float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
BH_HD float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
BH_HD float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
// Bounds by value: a reference would odr-use a namespace constant, which
// device code cannot.
template <typename T, typename B>
BH_HD T jclip(const T& x, B lo, B hi) {
  return jmin(jmax(x, lo), hi);
}
BH_HD bool is_finite(float x) { return fabsf(x) <= FLT_BIG; }
BH_HD float sqrt_(float x) { return sqrtf(x); }
// lax.rsqrt as 1 / sqrt.
BH_HD float rsqrt_(float x) { return 1.0f / sqrtf(x); }
BH_HD float log_(float x) { return logf(x); }
BH_HD float exp_(float x) { return expf(x); }
BH_HD float abs_(float x) { return fabsf(x); }
BH_HD float val(float x) { return x; }
// Tangent-only operations: nothing to do on a float state.
BH_HD void slave_trig(float&, float&, float&, float&, float, float) {}
BH_HD void guard(State&) {}

BH_HD Scal load_scal(const float* s) {
  return Scal{s[0], s[1], s[2], s[3], s[4],  s[5],
              s[6], s[7], s[8], s[9], s[10], s[11]};
}

// Geodesic RHS on the trig-augmented 10-state
// c = (r, th, ph, pr, pth, t, st, ct, sp, cp) with E = 1 (pallas _rhs).
template <typename T>
BH_HD void rhs(const T c[10], const T& L, const ScalT<T>& s, T k[10]) {
  const T r = c[0], pr = c[3], pth = c[4];
  const T st = c[6], ct = c[7], sp = c[8], cp = c[9];
  const T M = s.M, a = s.a, Q = s.Q;
  const T st2 = jmax(st * st, EPS);
  const T a2 = a * a;
  const T sigma = r * r + a2 * ct * ct;
  const T delta = r * r - 2.0f * M * r + a2 + Q * Q;
  const T tm = 2.0f * M * r - Q * Q;
  const T r2a2 = r * r + a2;
  const T A = r2a2 * r2a2 - delta * a2 * st2;
  const T inv_sd = 1.0f / (sigma * delta);
  const T inv_sigma = 1.0f / sigma;

  const T g_rr_up = delta * inv_sigma;
  const T g_thth_up = inv_sigma;
  const T g_tphi_up = -tm * a * inv_sd;
  const T g_tt_up = -A * inv_sd;
  const T g_phph_up = (delta - a2 * st2) * inv_sd / st2;

  const T dr = g_rr_up * pr;
  const T dth = g_thth_up * pth;
  const T dph = -g_tphi_up + g_phph_up * L;
  const T dtt = -g_tt_up + g_tphi_up * L;

  // dH/dr
  const T dsigma = 2.0f * r;
  const T ddelta = 2.0f * r - 2.0f * M;
  const T dA = 4.0f * r * r2a2 - ddelta * a2 * st2;
  const T dinv_sd = -(dsigma * delta + sigma * ddelta) * inv_sd * inv_sd;
  const T dg_tt = -(dA * inv_sd + A * dinv_sd);
  const T dg_tphi = -a * (2.0f * M * inv_sd + tm * dinv_sd);
  const T dg_rr = (ddelta * sigma - delta * dsigma) * inv_sigma * inv_sigma;
  const T dg_thth = -dsigma * inv_sigma * inv_sigma;
  const T dg_phph = (ddelta * inv_sd + (delta - a2 * st2) * dinv_sd) / st2;
  const T dH_dr = 0.5f * (dg_tt - 2.0f * dg_tphi * L + dg_phph * L * L +
                          dg_rr * pr * pr + dg_thth * pth * pth);

  // dH/dtheta
  const T dst2 = 2.0f * st * ct;
  const T dsigma_th = -a2 * dst2;
  const T dA_th = -delta * a2 * dst2;
  const T dinv_sd_th = -(dsigma_th * delta) * inv_sd * inv_sd;
  const T dg_tt_th = -(dA_th * inv_sd + A * dinv_sd_th);
  const T dg_tphi_th = -tm * a * dinv_sd_th;
  const T dg_rr_th = -delta * dsigma_th * inv_sigma * inv_sigma;
  const T dg_thth_th = -dsigma_th * inv_sigma * inv_sigma;
  const T num = delta - a2 * st2;
  const T dnum = -a2 * dst2;
  const T dg_phph_th = dnum * inv_sd / st2 + num * dinv_sd_th / st2 -
                       num * inv_sd * dst2 / (st2 * st2);
  const T dH_dth =
      0.5f * (dg_tt_th - 2.0f * dg_tphi_th * L + dg_phph_th * L * L +
              dg_rr_th * pr * pr + dg_thth_th * pth * pth);

  k[0] = dr;
  k[1] = dth;
  k[2] = dph;
  k[3] = -dH_dr;
  k[4] = -dH_dth;
  k[5] = dtt;
  k[6] = ct * dth;
  k[7] = -st * dth;
  k[8] = cp * dph;
  k[9] = -sp * dph;
}

template <typename T>
BH_HD void cart(const T& r, const T& st, const T& ct, const T& sp,
                const T& cp, const T& a, T& x, T& y, T& z) {
  const T w = sqrt_(r * r + a * a);
  const T rho = w * st;
  x = rho * cp;
  y = rho * sp;
  z = r * ct;
}

// Set the carried point (CarriesPoint) from the state before its first
// step, by the expression each step computes its new point with.
template <typename T, bool TRACK>
BH_HD void start_point(StateT<T, TRACK>& S, const ScalT<T>& s) {
  if constexpr (CarriesPoint<T>::value)
    cart(S.r, S.sth, S.cth, S.sph, S.cph, s.a, S.cx, S.cy, S.cz);
}

template <typename T, bool DISK_ON, bool ADAPTIVE, bool TRACK = false>
BH_HD void step_update(StateT<T, TRACK>& S, const T& L, const ScalT<T>& s) {
  const bool active = S.result == ACTIVE;
  const T dt = s.dt;
  const T rs = 2.0f * s.M;
  T h;
  if (ADAPTIVE) {
    h = S.h;
  } else {
    h = dt * jclip(S.r / (7.5f * rs), 0.05f, 20.0f);
    h = jmin(h, 0.5f * (S.r - s.r_capture) + 1e-3f * dt);
    h = jmax(h, 1e-4f * dt);
  }
  const T cur[10] = {S.r, S.th, S.ph, S.pr, S.pth,
                     S.t, S.sth, S.cth, S.sph, S.cph};
  T y[10], tmp[10];
  bool accepted = true;
  T h_next = S.h;
  if (!ADAPTIVE) {
    T k1[10], k2[10], k3[10], k4[10];
    const T hh = 0.5f * h;
    rhs(cur, L, s, k1);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + hh * k1[c];
    rhs(tmp, L, s, k2);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + hh * k2[c];
    rhs(tmp, L, s, k3);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + h * k3[c];
    rhs(tmp, L, s, k4);
    const T sixth = h / 6.0f;
    for (int c = 0; c < 10; ++c)
      y[c] = cur[c] + sixth * (k1[c] + 2.0f * (k2[c] + k3[c]) + k4[c]);
  } else {
    T k1[10], k2[10], k3[10], k4[10], k5[10], k6[10], y4[10];
    rhs(cur, L, s, k1);
    {
      const T c1 = h * B21;
      for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + c1 * k1[c];
    }
    rhs(tmp, L, s, k2);
    {
      const T c1 = h * B31, c2 = h * B32;
      for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c];
    }
    rhs(tmp, L, s, k3);
    {
      const T c1 = h * B41, c2 = h * B42, c3 = h * B43;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c];
    }
    rhs(tmp, L, s, k4);
    {
      const T c1 = h * B51, c2 = h * B52, c3 = h * B53, c4 = h * B54;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c] + c4 * k4[c];
    }
    rhs(tmp, L, s, k5);
    {
      const T c1 = h * B61, c2 = h * B62, c3 = h * B63, c4 = h * B64,
              c5 = h * B65;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c] + c4 * k4[c] +
                 c5 * k5[c];
    }
    rhs(tmp, L, s, k6);
    {
      const T c1 = h * C1, c3 = h * C3, c4 = h * C4, c5 = h * C5;
      for (int c = 0; c < 10; ++c)
        y4[c] = cur[c] + c1 * k1[c] + c3 * k3[c] + c4 * k4[c] + c5 * k5[c];
    }
    {
      const T c1 = h * D1, c3 = h * D3, c4 = h * D4, c5 = h * D5,
              c6 = h * D6;
      for (int c = 0; c < 10; ++c)
        y[c] = cur[c] + c1 * k1[c] + c3 * k3[c] + c4 * k4[c] + c5 * k5[c] +
               c6 * k6[c];
    }
    // Max relative error over the 6 physical components.
    T err(0.0f);
    for (int c = 0; c < 6; ++c) {
      const T scale = jmax(jmax(abs_(cur[c]), abs_(y[c])), 1e-12f);
      const T e = abs_(y[c] - y4[c]) / scale;
      err = (c == 0) ? e : jmax(err, e);
    }
    accepted = err <= s.tol;
    const T ratio = err / s.tol;
    const T log_ratio = log_(jmax(ratio, 1e-30f));
    // The accepted or the rejected branch's exponent, then one exp: the
    // same bits as selecting between both branches' scales.
    T sc = SAFETY * exp_((accepted ? -0.2f : -0.25f) * log_ratio);
    sc = (ratio <= 0.0f) ? T(MAX_SCALE) : sc;
    h_next = h * jclip(sc, MIN_SCALE, MAX_SCALE);
    h_next = jclip(h_next, 1e-4f * dt, 50.0f * dt);
    h_next = jmin(h_next, 0.5f * (S.r - s.r_capture) + 1e-3f * dt);
    h_next = jmax(h_next, 1e-5f * dt);
  }

  const bool fin = is_finite(y[0]) && is_finite(y[1]) && is_finite(y[2]) &&
                   is_finite(y[3]) && is_finite(y[4]);
  const bool advance = active && accepted && fin;
  const T r_n = advance ? y[0] : S.r;
  const T th_n = advance ? y[1] : S.th;
  const T ph_n = advance ? y[2] : S.ph;
  const T pr_n = advance ? y[3] : S.pr;
  const T pth_n = advance ? y[4] : S.pth;
  const T t_n = advance ? y[5] : S.t;
  T sth_n = advance ? y[6] : S.sth;
  T cth_n = advance ? y[7] : S.cth;
  T sph_n = advance ? y[8] : S.sph;
  T cph_n = advance ? y[9] : S.cph;
  T h_new = active ? h_next : S.h;

  // Unit-circle renormalisation.
  const T n_th = rsqrt_(jmax(sth_n * sth_n + cth_n * cth_n, 0.25f));
  sth_n = sth_n * n_th;
  cth_n = cth_n * n_th;
  const T n_ph = rsqrt_(jmax(sph_n * sph_n + cph_n * cph_n, 0.25f));
  sph_n = sph_n * n_ph;
  cph_n = cph_n * n_ph;
  // Tangents only: slave the trig tangents to dth, dph before the
  // cartesian conversion of the new point.
  slave_trig(sth_n, cth_n, sph_n, cph_n, th_n, ph_n);

  T cx, cy, cz, cx_n, cy_n, cz_n;
  if constexpr (CarriesPoint<T>::value) {
    cx = S.cx;
    cy = S.cy;
    cz = S.cz;
  } else {
    cart(S.r, S.sth, S.cth, S.sph, S.cph, s.a, cx, cy, cz);
  }
  cart(r_n, sth_n, cth_n, sph_n, cph_n, s.a, cx_n, cy_n, cz_n);
  const T dxc = cx_n - cx, dyc = cy_n - cy, dzc = cz_n - cz;
  const T step_len = sqrt_(dxc * dxc + dyc * dyc + dzc * dzc + 1e-24f);
  const T inv_len = 1.0f / jmax(step_len, EPS);
  T dist_n = S.dist + (advance ? step_len : T(0.0f));
  if (advance) {
    S.lx = dxc * inv_len;
    S.ly = dyc * inv_len;
    S.lz = dzc * inv_len;
  }

  T result = S.result;
  if (DISK_ON) {
    const T z_prev = -s.sin_incl * cy + s.cos_incl * cz;
    const T z_new = -s.sin_incl * cy_n + s.cos_incl * cz_n;
    const bool crossed = (z_prev * z_new < 0.0f) && advance;
    // The crossing point only on a crossing step (one in hundreds): no
    // other step reads it.
    if (crossed) {
      const T denom = z_prev - z_new;
      const T frac = z_prev / (abs_(denom) < EPS ? T(EPS) : denom);
      const T px = cx + frac * dxc;
      const T py = cy + frac * dyc;
      const T pz = cz + frac * dzc;
      const T yp = s.cos_incl * py + s.sin_incl * pz;
      const T r_plane = sqrt_(px * px + yp * yp);
      if (r_plane >= s.disk_inner && r_plane <= s.disk_outer) {
        result = T(DISK);
        S.hx = px;
        S.hy = py;
        S.hz = pz;
        dist_n = S.dist + frac * step_len;
      }
    }
    if constexpr (TRACK) {
      // Crossing-opacity tracking: the least sampled |z'| while radially
      // inside the annulus (strict <), and the post-step position and
      // chord direction there (dxc * inv_len, which the last direction
      // already holds: a candidate advanced).  The radius in the plane
      // only for a candidate.
      const T z_abs = abs_(z_new);
      if (advance && z_abs < S.min_az) {
        const T yp_n = s.cos_incl * cy_n + s.sin_incl * cz_n;
        const T r_plane_n = sqrt_(cx_n * cx_n + yp_n * yp_n);
        if (r_plane_n >= s.disk_inner && r_plane_n <= s.disk_outer) {
          S.min_az = z_abs;
          S.gx = cx_n;
          S.gy = cy_n;
          S.gz = cz_n;
          S.gdx = S.lx;
          S.gdy = S.ly;
          S.gdz = S.lz;
        }
      }
    }
    if (ADAPTIVE) {
      // Disk-aware clamp: cap an approaching in-band ray's next step at
      // ~1.25x its estimated plane-crossing time.
      const T dz = z_new - z_prev;
      const bool approaching = z_new * dz < 0.0f;
      const T lam_cross = h * abs_(z_new) / jmax(abs_(dz), EPS);
      const bool near = r_n < 1.5f * s.disk_outer;
      const T h_cap = jmax(1.25f * lam_cross, 0.05f * dt);
      if (active && approaching && near) h_new = jmin(h_new, h_cap);
    }
  }

  // Termination tests in the reference's order; each reads `still` anew.
  // The early shell capture ignores charge, as the reference does.
  bool still = result == ACTIVE;
  const bool pinned = (pr_n < -1e6f) || (abs_(pr_n) > 1e7f);
  const bool shell_capture = (pr_n < 0.0f) && (r_n < 0.999f * s.r_shell_min);
  if (still && active &&
      (r_n <= s.r_capture || shell_capture || pinned || !fin)) {
    result = T(HORIZON);
    S.hx = cx_n;
    S.hy = cy_n;
    S.hz = cz_n;
  }
  still = result == ACTIVE;
  if (still && advance && dist_n >= s.max_dist) {
    result = T(MAX_DISTANCE);
    S.hx = cx_n;
    S.hy = cy_n;
    S.hz = cz_n;
  }
  still = result == ACTIVE;
  if (still && advance && r_n >= s.max_dist && pr_n > 0.0f) {
    result = T(BACKGROUND);
    S.hx = cx_n;
    S.hy = cy_n;
    S.hz = cz_n;
  }

  if (active) S.steps = S.steps + 1.0f;
  if (advance) S.min_r = jmin(S.min_r, r_n);
  S.r = r_n;
  S.th = th_n;
  S.ph = ph_n;
  S.pr = pr_n;
  S.pth = pth_n;
  S.sth = sth_n;
  S.cth = cth_n;
  S.sph = sph_n;
  S.cph = cph_n;
  S.dist = dist_n;
  S.result = result;
  S.t = t_n;
  S.h = h_new;
  if constexpr (CarriesPoint<T>::value) {
    S.cx = cx_n;
    S.cy = cy_n;
    S.cz = cz_n;
  }
}

// Integrate ray i of the (16, n) input planes to its retirement or
// max_steps, and store its n_out(TRACK) output planes (K1).  TRACK needs
// DISK_ON: the tracking updates live in the disk block.
template <bool DISK_ON, bool ADAPTIVE, bool TRACK = false>
BH_HD void trace_ray(const float* inp, float* out, long long n, long long i,
                     const Scal& s, int max_steps) {
  static_assert(DISK_ON || !TRACK, "tracking needs the disk");
  StateT<float, TRACK> S;
  S.r = inp[0 * n + i];
  S.th = inp[1 * n + i];
  S.ph = inp[2 * n + i];
  S.pr = inp[3 * n + i];
  S.pth = inp[4 * n + i];
  const float L = inp[5 * n + i];
  S.hx = inp[6 * n + i];
  S.hy = inp[7 * n + i];
  S.hz = inp[8 * n + i];
  S.lx = inp[9 * n + i];
  S.ly = inp[10 * n + i];
  S.lz = inp[11 * n + i];
  S.sth = inp[12 * n + i];
  S.cth = inp[13 * n + i];
  S.sph = inp[14 * n + i];
  S.cph = inp[15 * n + i];
  S.dist = 0.0f;
  S.steps = 0.0f;
  S.result = ACTIVE;
  S.t = 0.0f;
  S.h = s.dt;
  S.min_r = S.r;
  if constexpr (TRACK) {
    S.min_az = 1e9f;
    S.gx = S.hx;
    S.gy = S.hy;
    S.gz = S.hz;
    S.gdx = S.lx;
    S.gdy = S.ly;
    S.gdz = S.lz;
  }
  start_point(S, s);
  for (int it = 0; it < max_steps && S.result == ACTIVE; ++it)
    step_update<float, DISK_ON, ADAPTIVE, TRACK>(S, L, s);
  out[0 * n + i] = S.result;
  out[1 * n + i] = S.dist;
  out[2 * n + i] = S.steps;
  out[3 * n + i] = S.hx;
  out[4 * n + i] = S.hy;
  out[5 * n + i] = S.hz;
  out[6 * n + i] = S.lx;
  out[7 * n + i] = S.ly;
  out[8 * n + i] = S.lz;
  out[9 * n + i] = S.r;
  out[10 * n + i] = S.sth;
  out[11 * n + i] = S.cth;
  out[12 * n + i] = S.sph;
  out[13 * n + i] = S.cph;
  out[14 * n + i] = S.min_r;
  if constexpr (TRACK) {
    out[15 * n + i] = S.min_az;
    out[16 * n + i] = S.gx;
    out[17 * n + i] = S.gy;
    out[18 * n + i] = S.gz;
    out[19 * n + i] = S.gdx;
    out[20 * n + i] = S.gdy;
    out[21 * n + i] = S.gdz;
  }
}

}  // namespace bh
