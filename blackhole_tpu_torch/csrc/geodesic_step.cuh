// One masked geodesic integration step, and the per-ray loop around it.
//
// Port of the loop body of the Pallas TPU kernel
// blackhole_tpu/render/pallas_kernel.py (_step_update, _rhs, _cart,
// _load_init, _store_out), written once for the CUDA kernel
// (trace_kernel.cu) and for a host build with a plain C++ compiler: BH_HD
// is __host__ __device__ under nvcc and plain inline otherwise.  Its plain
// PyTorch version is blackhole_tpu_torch/render/trace_kernel.py
// (step_update, trace_planes_plain); keep the two in step.
//
// Rounding follows the JAX package's float32 arithmetic: every constant
// is a float (a double quotient cast once, as JAX rounds a Python float),
// operations keep the reference's order, and the max/min helpers
// propagate NaN as jnp.maximum/jnp.minimum do (fmaxf/fminf drop it).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define BH_HD __host__ __device__ __forceinline__
#else
#define BH_HD inline
#endif

namespace bh {

constexpr int N_SCAL = 12;
constexpr int N_INP = 16;
constexpr int N_OUT = 15;

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

struct Scal {
  float M, a, Q, dt, max_dist, r_capture, disk_inner, disk_outer, sin_incl,
      cos_incl, tol, r_shell_min;
};

// The 21 state slots of pallas_kernel._step_update.
struct State {
  float r, th, ph, pr, pth, sth, cth, sph, cph;
  float dist, steps, result, hx, hy, hz, lx, ly, lz, t, h, min_r;
};

// jnp.maximum / jnp.minimum / jnp.clip: NaN in either argument wins.
BH_HD float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
BH_HD float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
BH_HD float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
BH_HD bool is_finite(float x) { return fabsf(x) <= FLT_BIG; }

BH_HD Scal load_scal(const float* s) {
  return Scal{s[0], s[1], s[2], s[3], s[4],  s[5],
              s[6], s[7], s[8], s[9], s[10], s[11]};
}

// Geodesic RHS on the trig-augmented 10-state
// c = (r, th, ph, pr, pth, t, st, ct, sp, cp) with E = 1 (pallas _rhs).
BH_HD void rhs(const float c[10], float L, const Scal& s, float k[10]) {
  const float r = c[0], pr = c[3], pth = c[4];
  const float st = c[6], ct = c[7], sp = c[8], cp = c[9];
  const float M = s.M, a = s.a, Q = s.Q;
  const float st2 = jmax(st * st, EPS);
  const float a2 = a * a;
  const float sigma = r * r + a2 * ct * ct;
  const float delta = r * r - 2.0f * M * r + a2 + Q * Q;
  const float tm = 2.0f * M * r - Q * Q;
  const float r2a2 = r * r + a2;
  const float A = r2a2 * r2a2 - delta * a2 * st2;
  const float inv_sd = 1.0f / (sigma * delta);
  const float inv_sigma = 1.0f / sigma;

  const float g_rr_up = delta * inv_sigma;
  const float g_thth_up = inv_sigma;
  const float g_tphi_up = -tm * a * inv_sd;
  const float g_tt_up = -A * inv_sd;
  const float g_phph_up = (delta - a2 * st2) * inv_sd / st2;

  const float dr = g_rr_up * pr;
  const float dth = g_thth_up * pth;
  const float dph = -g_tphi_up + g_phph_up * L;
  const float dtt = -g_tt_up + g_tphi_up * L;

  // dH/dr
  const float dsigma = 2.0f * r;
  const float ddelta = 2.0f * r - 2.0f * M;
  const float dA = 4.0f * r * r2a2 - ddelta * a2 * st2;
  const float dinv_sd = -(dsigma * delta + sigma * ddelta) * inv_sd * inv_sd;
  const float dg_tt = -(dA * inv_sd + A * dinv_sd);
  const float dg_tphi = -a * (2.0f * M * inv_sd + tm * dinv_sd);
  const float dg_rr = (ddelta * sigma - delta * dsigma) * inv_sigma * inv_sigma;
  const float dg_thth = -dsigma * inv_sigma * inv_sigma;
  const float dg_phph = (ddelta * inv_sd + (delta - a2 * st2) * dinv_sd) / st2;
  const float dH_dr = 0.5f * (dg_tt - 2.0f * dg_tphi * L + dg_phph * L * L +
                              dg_rr * pr * pr + dg_thth * pth * pth);

  // dH/dtheta
  const float dst2 = 2.0f * st * ct;
  const float dsigma_th = -a2 * dst2;
  const float dA_th = -delta * a2 * dst2;
  const float dinv_sd_th = -(dsigma_th * delta) * inv_sd * inv_sd;
  const float dg_tt_th = -(dA_th * inv_sd + A * dinv_sd_th);
  const float dg_tphi_th = -tm * a * dinv_sd_th;
  const float dg_rr_th = -delta * dsigma_th * inv_sigma * inv_sigma;
  const float dg_thth_th = -dsigma_th * inv_sigma * inv_sigma;
  const float num = delta - a2 * st2;
  const float dnum = -a2 * dst2;
  const float dg_phph_th = dnum * inv_sd / st2 + num * dinv_sd_th / st2 -
                           num * inv_sd * dst2 / (st2 * st2);
  const float dH_dth =
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

BH_HD void cart(float r, float st, float ct, float sp, float cp, float a,
                float& x, float& y, float& z) {
  const float w = sqrtf(r * r + a * a);
  const float rho = w * st;
  x = rho * cp;
  y = rho * sp;
  z = r * ct;
}

template <bool DISK_ON, bool ADAPTIVE>
BH_HD void step_update(State& S, float L, const Scal& s) {
  const bool active = S.result == ACTIVE;
  const float dt = s.dt;
  const float rs = 2.0f * s.M;
  float h;
  if (ADAPTIVE) {
    h = S.h;
  } else {
    h = dt * jclip(S.r / (7.5f * rs), 0.05f, 20.0f);
    h = jmin(h, 0.5f * (S.r - s.r_capture) + 1e-3f * dt);
    h = jmax(h, 1e-4f * dt);
  }
  const float cur[10] = {S.r, S.th, S.ph, S.pr, S.pth,
                         S.t, S.sth, S.cth, S.sph, S.cph};
  float y[10], tmp[10];
  bool accepted = true;
  float h_next = S.h;
  if (!ADAPTIVE) {
    float k1[10], k2[10], k3[10], k4[10];
    const float hh = 0.5f * h;
    rhs(cur, L, s, k1);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + hh * k1[c];
    rhs(tmp, L, s, k2);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + hh * k2[c];
    rhs(tmp, L, s, k3);
    for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + h * k3[c];
    rhs(tmp, L, s, k4);
    const float sixth = h / 6.0f;
    for (int c = 0; c < 10; ++c)
      y[c] = cur[c] + sixth * (k1[c] + 2.0f * (k2[c] + k3[c]) + k4[c]);
  } else {
    float k1[10], k2[10], k3[10], k4[10], k5[10], k6[10], y4[10];
    rhs(cur, L, s, k1);
    {
      const float c1 = h * B21;
      for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + c1 * k1[c];
    }
    rhs(tmp, L, s, k2);
    {
      const float c1 = h * B31, c2 = h * B32;
      for (int c = 0; c < 10; ++c) tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c];
    }
    rhs(tmp, L, s, k3);
    {
      const float c1 = h * B41, c2 = h * B42, c3 = h * B43;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c];
    }
    rhs(tmp, L, s, k4);
    {
      const float c1 = h * B51, c2 = h * B52, c3 = h * B53, c4 = h * B54;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c] + c4 * k4[c];
    }
    rhs(tmp, L, s, k5);
    {
      const float c1 = h * B61, c2 = h * B62, c3 = h * B63, c4 = h * B64,
                  c5 = h * B65;
      for (int c = 0; c < 10; ++c)
        tmp[c] = cur[c] + c1 * k1[c] + c2 * k2[c] + c3 * k3[c] + c4 * k4[c] +
                 c5 * k5[c];
    }
    rhs(tmp, L, s, k6);
    {
      const float c1 = h * C1, c3 = h * C3, c4 = h * C4, c5 = h * C5;
      for (int c = 0; c < 10; ++c)
        y4[c] = cur[c] + c1 * k1[c] + c3 * k3[c] + c4 * k4[c] + c5 * k5[c];
    }
    {
      const float c1 = h * D1, c3 = h * D3, c4 = h * D4, c5 = h * D5,
                  c6 = h * D6;
      for (int c = 0; c < 10; ++c)
        y[c] = cur[c] + c1 * k1[c] + c3 * k3[c] + c4 * k4[c] + c5 * k5[c] +
               c6 * k6[c];
    }
    // Max relative error over the 6 physical components.
    float err = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const float scale = jmax(jmax(fabsf(cur[c]), fabsf(y[c])), 1e-12f);
      const float e = fabsf(y[c] - y4[c]) / scale;
      err = (c == 0) ? e : jmax(err, e);
    }
    accepted = err <= s.tol;
    const float log_ratio = logf(jmax(err / s.tol, 1e-30f));
    const float scale_ok = SAFETY * expf(-0.2f * log_ratio);
    const float scale_bad = SAFETY * expf(-0.25f * log_ratio);
    float sc = accepted ? scale_ok : scale_bad;
    sc = (err / s.tol <= 0.0f) ? MAX_SCALE : sc;
    h_next = h * jclip(sc, MIN_SCALE, MAX_SCALE);
    h_next = jclip(h_next, 1e-4f * dt, 50.0f * dt);
    h_next = jmin(h_next, 0.5f * (S.r - s.r_capture) + 1e-3f * dt);
    h_next = jmax(h_next, 1e-5f * dt);
  }

  const bool fin = is_finite(y[0]) && is_finite(y[1]) && is_finite(y[2]) &&
                   is_finite(y[3]) && is_finite(y[4]);
  const bool advance = active && accepted && fin;
  const float r_n = advance ? y[0] : S.r;
  const float th_n = advance ? y[1] : S.th;
  const float ph_n = advance ? y[2] : S.ph;
  const float pr_n = advance ? y[3] : S.pr;
  const float pth_n = advance ? y[4] : S.pth;
  const float t_n = advance ? y[5] : S.t;
  float sth_n = advance ? y[6] : S.sth;
  float cth_n = advance ? y[7] : S.cth;
  float sph_n = advance ? y[8] : S.sph;
  float cph_n = advance ? y[9] : S.cph;
  float h_new = active ? h_next : S.h;

  // Unit-circle renormalisation (lax.rsqrt as 1 / sqrt).
  const float n_th = 1.0f / sqrtf(jmax(sth_n * sth_n + cth_n * cth_n, 0.25f));
  sth_n = sth_n * n_th;
  cth_n = cth_n * n_th;
  const float n_ph = 1.0f / sqrtf(jmax(sph_n * sph_n + cph_n * cph_n, 0.25f));
  sph_n = sph_n * n_ph;
  cph_n = cph_n * n_ph;

  float cx, cy, cz, cx_n, cy_n, cz_n;
  cart(S.r, S.sth, S.cth, S.sph, S.cph, s.a, cx, cy, cz);
  cart(r_n, sth_n, cth_n, sph_n, cph_n, s.a, cx_n, cy_n, cz_n);
  const float dxc = cx_n - cx, dyc = cy_n - cy, dzc = cz_n - cz;
  const float step_len = sqrtf(dxc * dxc + dyc * dyc + dzc * dzc + 1e-24f);
  const float inv_len = 1.0f / jmax(step_len, EPS);
  float dist_n = S.dist + (advance ? step_len : 0.0f);
  if (advance) {
    S.lx = dxc * inv_len;
    S.ly = dyc * inv_len;
    S.lz = dzc * inv_len;
  }

  float result = S.result;
  if (DISK_ON) {
    const float z_prev = -s.sin_incl * cy + s.cos_incl * cz;
    const float z_new = -s.sin_incl * cy_n + s.cos_incl * cz_n;
    const bool crossed = (z_prev * z_new < 0.0f) && advance;
    const float denom = z_prev - z_new;
    const float frac = z_prev / (fabsf(denom) < EPS ? EPS : denom);
    const float px = cx + frac * dxc;
    const float py = cy + frac * dyc;
    const float pz = cz + frac * dzc;
    const float yp = s.cos_incl * py + s.sin_incl * pz;
    const float r_plane = sqrtf(px * px + yp * yp);
    const bool in_annulus = r_plane >= s.disk_inner && r_plane <= s.disk_outer;
    if (crossed && in_annulus) {
      result = DISK;
      S.hx = px;
      S.hy = py;
      S.hz = pz;
      dist_n = S.dist + frac * step_len;
    }
    if (ADAPTIVE) {
      // Disk-aware clamp: cap an approaching in-band ray's next step at
      // ~1.25x its estimated plane-crossing time.
      const float dz = z_new - z_prev;
      const bool approaching = z_new * dz < 0.0f;
      const float lam_cross = h * fabsf(z_new) / jmax(fabsf(dz), EPS);
      const bool near = r_n < 1.5f * s.disk_outer;
      const float h_cap = jmax(1.25f * lam_cross, 0.05f * dt);
      if (active && approaching && near) h_new = jmin(h_new, h_cap);
    }
  }

  // Termination tests in the reference's order; each reads `still` anew.
  // The early shell capture ignores charge, as the reference does.
  bool still = result == ACTIVE;
  const bool pinned = (pr_n < -1e6f) || (fabsf(pr_n) > 1e7f);
  const bool shell_capture = (pr_n < 0.0f) && (r_n < 0.999f * s.r_shell_min);
  if (still && active &&
      (r_n <= s.r_capture || shell_capture || pinned || !fin)) {
    result = HORIZON;
    S.hx = cx_n;
    S.hy = cy_n;
    S.hz = cz_n;
  }
  still = result == ACTIVE;
  if (still && advance && dist_n >= s.max_dist) {
    result = MAX_DISTANCE;
    S.hx = cx_n;
    S.hy = cy_n;
    S.hz = cz_n;
  }
  still = result == ACTIVE;
  if (still && advance && r_n >= s.max_dist && pr_n > 0.0f) {
    result = BACKGROUND;
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
}

// Integrate ray i of the (16, n) input planes to its retirement or
// max_steps, and store its 15 output planes.
template <bool DISK_ON, bool ADAPTIVE>
BH_HD void trace_ray(const float* inp, float* out, long long n, long long i,
                     const Scal& s, int max_steps) {
  State S;
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
  for (int it = 0; it < max_steps && S.result == ACTIVE; ++it)
    step_update<DISK_ON, ADAPTIVE>(S, L, s);
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
}

}  // namespace bh
