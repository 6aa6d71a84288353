// Forward-mode dual number: a value and N tangents, for the multi-tangent
// geodesic kernel (trace_fwdgrad.cu).
//
// Dual<N, F> carries one primal and N tangent directions of base type F
// (float in the kernels; the tests put a counting type there to count the
// kernel's arithmetic).  Every operator computes the primal exactly as the
// float code does, and each tangent by jax.jvp's rule for that primitive,
// so the kernel's tangent recurrence is the one jax.jvp derived inside the
// JAX package's Pallas kernel, except that a quotient takes its tangents
// from one reciprocal of the divisor (an IEEE division costs about eight
// instructions on the card, a product one; the tangents move by ulps
// against jax.jvp's literal rule, and the primal keeps its division):
//   x / y   -> (dx - q dy) r        with q = x / y, r = 1 / y
//   c / y   -> dy (-(q r))          (c a float)
//   x / c   -> dx (1 / c)           (1 / c folds for a literal c)
//   x * y   -> dx y + x dy
//   sqrt x  -> dx (0.5 / sqrt x)    rsqrt x -> dx (-0.5 (rsqrt x / x))
//   log x   -> dx / x               exp x -> dx exp x
//   abs x   -> x >= 0 ? dx : -dx    (tangent +dx at 0)
//   max/min -> da wa + db wb, w = 1 on the side that is the result, 0.5
//              each at a tie, 0 both where the result is NaN.
// A float operand is a constant: it has no tangent and adds no term.
#pragma once

#include "geodesic_step.cuh"

namespace bh {

template <int N, typename F = float>
struct Dual {
  F v;
  F d[N];
  BH_HD Dual() {}
  BH_HD explicit Dual(float x) : v(x) {
    for (int i = 0; i < N; ++i) d[i] = F(0.0f);
  }
};

// A Dual state recomputes its point each step (see CarriesPoint).
template <int N, typename F>
struct CarriesPoint<Dual<N, F>> {
  static constexpr bool value = false;
};

#define BH_DUAL template <int N, typename F>
#define BH_D Dual<N, F>

BH_DUAL BH_HD BH_D operator-(const BH_D& a) {
  BH_D r;
  r.v = -a.v;
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator+(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = a.v + b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator+(const BH_D& a, float c) {
  BH_D r;
  r.v = a.v + c;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator+(float c, const BH_D& b) {
  BH_D r;
  r.v = c + b.v;
  for (int i = 0; i < N; ++i) r.d[i] = b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator-(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = a.v - b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator-(const BH_D& a, float c) {
  BH_D r;
  r.v = a.v - c;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator-(float c, const BH_D& b) {
  BH_D r;
  r.v = c - b.v;
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator*(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = a.v * b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator*(const BH_D& a, float c) {
  BH_D r;
  r.v = a.v * c;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * c;
  return r;
}
BH_DUAL BH_HD BH_D operator*(float c, const BH_D& b) {
  BH_D r;
  r.v = c * b.v;
  for (int i = 0; i < N; ++i) r.d[i] = c * b.d[i];
  return r;
}
BH_DUAL BH_HD BH_D operator/(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = a.v / b.v;
  const F rb = 1.0f / b.v;
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * rb;
  return r;
}
BH_DUAL BH_HD BH_D operator/(const BH_D& a, float c) {
  BH_D r;
  r.v = a.v / c;
  const float rc = 1.0f / c;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * rc;
  return r;
}
BH_DUAL BH_HD BH_D operator/(float c, const BH_D& b) {
  BH_D r;
  r.v = c / b.v;
  const F k = r.v * (1.0f / b.v);
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i] * k;
  return r;
}

// Comparisons read the primal.
BH_DUAL BH_HD bool operator<(const BH_D& a, float c) { return a.v < c; }
BH_DUAL BH_HD bool operator<=(const BH_D& a, float c) { return a.v <= c; }
BH_DUAL BH_HD bool operator>(const BH_D& a, float c) { return a.v > c; }
BH_DUAL BH_HD bool operator>=(const BH_D& a, float c) { return a.v >= c; }
BH_DUAL BH_HD bool operator==(const BH_D& a, float c) { return a.v == c; }
BH_DUAL BH_HD bool operator<(const BH_D& a, const BH_D& b) { return a.v < b.v; }
BH_DUAL BH_HD bool operator<=(const BH_D& a, const BH_D& b) {
  return a.v <= b.v;
}
BH_DUAL BH_HD bool operator>(const BH_D& a, const BH_D& b) { return a.v > b.v; }
BH_DUAL BH_HD bool operator>=(const BH_D& a, const BH_D& b) {
  return a.v >= b.v;
}

BH_DUAL BH_HD bool is_finite(const BH_D& a) { return is_finite(a.v); }

BH_DUAL BH_HD BH_D sqrt_(const BH_D& a) {
  BH_D r;
  r.v = sqrt_(a.v);
  const F h = 0.5f / r.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * h;
  return r;
}
BH_DUAL BH_HD BH_D rsqrt_(const BH_D& a) {
  BH_D r;
  r.v = rsqrt_(a.v);
  const F q = -0.5f * (r.v / a.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * q;
  return r;
}
BH_DUAL BH_HD BH_D log_(const BH_D& a) {
  BH_D r;
  r.v = log_(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / a.v;
  return r;
}
BH_DUAL BH_HD BH_D exp_(const BH_D& a) {
  BH_D r;
  r.v = exp_(a.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * r.v;
  return r;
}
BH_DUAL BH_HD BH_D abs_(const BH_D& a) {
  BH_D r;
  r.v = abs_(a.v);
  const bool pos = a.v >= 0.0f;
  for (int i = 0; i < N; ++i) r.d[i] = pos ? a.d[i] : -a.d[i];
  return r;
}

// jax.jvp's weight of an operand of max/min: 1 if it is the result, 0.5
// if the other operand is too (a tie), 0 if not (and both 0 at NaN).
template <typename F>
BH_HD float tie_weight(const F& x, const F& other, const F& r) {
  return x == r ? (other == r ? 0.5f : 1.0f) : 0.0f;
}

BH_DUAL BH_HD BH_D jmax(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = jmax(a.v, b.v);
  const float wa = tie_weight(a.v, b.v, r.v), wb = tie_weight(b.v, a.v, r.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * wa + b.d[i] * wb;
  return r;
}
BH_DUAL BH_HD BH_D jmin(const BH_D& a, const BH_D& b) {
  BH_D r;
  r.v = jmin(a.v, b.v);
  const float wa = tie_weight(a.v, b.v, r.v), wb = tie_weight(b.v, a.v, r.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * wa + b.d[i] * wb;
  return r;
}
BH_DUAL BH_HD BH_D jmax(const BH_D& a, float c) {
  BH_D r;
  r.v = jmax(a.v, c);
  const float wa = tie_weight(a.v, F(c), r.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * wa;
  return r;
}
BH_DUAL BH_HD BH_D jmin(const BH_D& a, float c) {
  BH_D r;
  r.v = jmin(a.v, c);
  const float wa = tie_weight(a.v, F(c), r.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * wa;
  return r;
}

// The trig tangents are overwritten with the constraint-consistent
// d(sin x) = cos x dx, d(cos x) = -sin x dx (the JAX package's
// _slave_trig), from the renormalised primal.
BH_DUAL BH_HD void slave_trig(BH_D& st, BH_D& ct, BH_D& sp, BH_D& cp,
                              const BH_D& th, const BH_D& ph) {
  for (int i = 0; i < N; ++i) {
    st.d[i] = ct.v * th.d[i];
    ct.d[i] = -st.v * th.d[i];
    sp.d[i] = cp.v * ph.d[i];
    cp.d[i] = -sp.v * ph.d[i];
  }
}

// The per-step tangent guard (the JAX package's sensitivity.tangent_guard
// as its multi-tangent kernel applies it): per direction, mag is the
// NaN-propagating max of |d| over the state slots, the 7 tracking slots
// included under TRACK (L rides in the scalars and is outside it), factor
// = LIMIT / max(mag, LIMIT), or 0 where mag is not finite, and each slot
// becomes (finite ? d : 0) * factor.  Where mag is finite and at most
// LIMIT (almost every step), every slot is finite and factor is exactly
// 1, so the guard is the identity and does no work: bitwise the same.
constexpr float TANGENT_LIMIT = 1.0e6f;

template <int N, typename F, bool TRACK>
BH_HD void guard(StateT<BH_D, TRACK>& S) {
  constexpr int NS = n_state(TRACK);
  BH_D* slot[NS];
  state_slots(S, slot);
BH_UNROLL
  for (int i = 0; i < N; ++i) {
    F mag = abs_(slot[0]->d[i]);
BH_UNROLL
    for (int k = 1; k < NS; ++k) mag = jmax(mag, abs_(slot[k]->d[i]));
    if (mag <= TANGENT_LIMIT) continue;  // false for NaN
    F factor = TANGENT_LIMIT / jmax(mag, TANGENT_LIMIT);
    if (!is_finite(mag)) factor = F(0.0f);
BH_UNROLL
    for (int k = 0; k < NS; ++k) {
      const F x = slot[k]->d[i];
      slot[k]->d[i] = (is_finite(x) ? x : F(0.0f)) * factor;
    }
  }
}

#undef BH_D
#undef BH_DUAL

// Integrate ray i with N tangent directions: the primal from scal (12,)
// and inp (16, n), the tangents from dscal (N, 12) and dinp (N, 16, n);
// store out ((1 + N) * P, n), P = n_out(TRACK), the primal's planes first.
// The initial tangent is init_slots (and init_track_slots) of the tangent
// planes with result 0, min_az 0 and h = d(time_step) (the JAX package's
// _load_init and _zero_ctrl_tangents).  TRACK needs DISK_ON.  F: the base
// type (float; the tests count operations with another).
template <int N, bool DISK_ON, bool ADAPTIVE, bool TRACK = false,
          typename F = float>
BH_HD void trace_ray_fwdgrad(const float* scal, const float* dscal,
                             const float* inp, const float* dinp, float* out,
                             long long n, long long i, int max_steps) {
  static_assert(DISK_ON || !TRACK, "tracking needs the disk");
  using D = Dual<N, F>;
  constexpr int NS = n_state(TRACK), P = n_out(TRACK);
  ScalT<D> s;
  D* sv[N_SCAL];
  scal_slots(s, sv);
BH_UNROLL
  for (int k = 0; k < N_SCAL; ++k) {
    sv[k]->v = F(scal[k]);
BH_UNROLL
    for (int j = 0; j < N; ++j) sv[k]->d[j] = F(dscal[j * N_SCAL + k]);
  }
  StateT<D, TRACK> S;
  D* slot[NS];
  state_slots(S, slot);
  float x[N_INP], init[NS];
BH_UNROLL
  for (int k = 0; k < N_INP; ++k) x[k] = inp[k * n + i];
  init_slots(x, scal[3], ACTIVE, init);
  if constexpr (TRACK) init_track_slots(x, 1e9f, init + N_STATE);
BH_UNROLL
  for (int k = 0; k < NS; ++k) slot[k]->v = F(init[k]);
  D L(x[5]);
BH_UNROLL
  for (int j = 0; j < N; ++j) {
    const float* dx_j = dinp + (long long)j * N_INP * n;
BH_UNROLL
    for (int k = 0; k < N_INP; ++k) x[k] = dx_j[k * n + i];
    init_slots(x, dscal[j * N_SCAL + 3], 0.0f, init);
    if constexpr (TRACK) init_track_slots(x, 0.0f, init + N_STATE);
BH_UNROLL
    for (int k = 0; k < NS; ++k) slot[k]->d[j] = F(init[k]);
    L.d[j] = F(x[5]);
  }
  for (int it = 0; it < max_steps && S.result == ACTIVE; ++it) {
    step_update<D, DISK_ON, ADAPTIVE, TRACK>(S, L, s);
    guard(S);
  }
BH_UNROLL
  for (int k = 0; k < P; ++k) {
    const D& v = *slot[TRACK ? out_slot_track(k) : out_slot(k)];
    out[k * n + i] = val(v.v);
BH_UNROLL
    for (int j = 0; j < N; ++j)
      out[((1 + j) * P + k) * n + i] = val(v.d[j]);
  }
}

}  // namespace bh
