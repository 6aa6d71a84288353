"""The multi-tangent geodesic step of the PyTorch port against jax.jvp.

step_update_jvp (the plain version of K2's step: torch.func.jvp of
tangent_guard(step_update(..., slave=True)) per tangent direction) against
jax.jvp of sensitivity.tangent_guard(2, pallas_kernel._step_update(...,
slave=True)), the function the JAX package's multi-tangent kernel
differentiates, called eagerly on the CPU outside Pallas.  Same random
float32 states, scalars and two tangent directions on both sides; every
primal and tangent slot compared.  Cases built to land on the ties where
torch's and JAX's derivative rules differ (clip at a bound, abs at 0,
max/min at a tie), a guard rescale and a NaN scrub are added.  The
port's tangent_guard and clip_color_tangent are compared with the JAX
functions directly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.grad import fast_grad as jfast_grad
from blackhole_tpu.integrate import sensitivity as jsens
from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.geom.types import Hit
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.integrate import sensitivity
from blackhole_tpu_torch import tangent_rules
from blackhole_tpu_torch.render import trace_kernel

from test_torch_step import TOLERANCE, _random_state

torch.set_num_threads(1)  # see tests/test_torch_step.py

_K = trace_kernel
# Tangent slots: both sides take the same derivative of the same float32
# operations, but torch's and JAX's rules for a product, quotient, sqrt
# and rsqrt round differently (e.g. d(x/y) is (dx - dy q)/y in torch and
# dx/y - dy x/y^2 in JAX), a few ulp of each intermediate.  Each slot's
# tangent is held to |got - ref| <= tol (|ref| + the slot's largest
# |ref|), tol per slot class (measured worst case on these states in
# brackets):
_TANGENT_TOL = {
    # Integrated BL state, t, trig, min_r: a few ulp (1.7e-7).
    **{s: 1e-6 for s in (_K.S_R, _K.S_TH, _K.S_PH, _K.S_PR, _K.S_PTH,
                         _K.S_T, _K.S_ST, _K.S_CT, _K.S_SP, _K.S_CP,
                         _K.S_MINR)},
    # Path length and hit position: the chord's tangent is the difference
    # of two cartesian tangents of the point's magnitude (radii to 90), so
    # ulp of those over short chords (8e-4).
    **{s: 2e-3 for s in (_K.S_DIST, _K.S_HX, _K.S_HY, _K.S_HZ)},
    # Step size: the RKF45 controller's log/exp and the disk-aware clamp
    # (4e-5).
    _K.S_H: 1e-4,
    # Last chord direction: the chord's tangent over its length (3.1e-3);
    # the primal contract of this slot is 1e-2 for the same reason.
    **{s: 1e-2 for s in (_K.S_LX, _K.S_LY, _K.S_LZ)},
}
# The discrete slots (steps, result) have exactly zero tangent.
_ZERO_TANGENT = (_K.S_STEPS, _K.S_RESULT)


def _tangents(state, seed, n_tan=2, scale=1.0, n_slots=_K.N_STATE):
    """Random float32 tangent directions of the state's first n_slots
    slots (zero for steps and result, whose tangents are exactly 0 in the
    kernel) and of the 13 scalars (dL per ray)."""
    rng = np.random.default_rng(seed)
    n = state[0].shape[0]
    dstates, dscals = [], []
    for _ in range(n_tan):
        ds = [rng.normal(0, scale, n).astype(np.float32)
              for _ in range(n_slots)]
        for s in _ZERO_TANGENT:
            ds[s] = np.zeros(n, np.float32)
        dsc = [np.float32(rng.normal(0, 1.0)) for _ in range(_K.N_SCAL)]
        dsc.append(rng.normal(0, 1.0, n).astype(np.float32))
        dstates.append(ds)
        dscals.append(dsc)
    return dstates, dscals


def _jax_step_jvp(state, scal, dstates, dscals, disk, adaptive,
                  track=False):
    """jax.jvp of the differentiated kernels' step, per direction, on
    (32, 128) tiles (ray_ndim 2, as inside the kernel)."""
    def tile(x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x.reshape(32, -1) if x.ndim else x)

    def f(st, sc):
        return jsens.tangent_guard(2, pallas_kernel._step_update(
            st, sc, disk, adaptive, track=track, slave=True))

    st = tuple(tile(s) for s in state)
    sc = tuple(tile(s) for s in scal)
    new, dnews = None, []
    for ds, dsc in zip(dstates, dscals):
        new, dnew = jax.jvp(f, (st, sc), (tuple(tile(x) for x in ds),
                                          tuple(tile(x) for x in dsc)))
        dnews.append([np.asarray(x).reshape(-1) for x in dnew])
    return [np.asarray(x).reshape(-1) for x in new], dnews


def _torch_step_jvp(state, scal, dstates, dscals, disk, adaptive,
                    track=False):
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    new, dnews = trace_kernel.step_update_jvp(
        tuple(t(s) for s in state),
        [tuple(t(x) for x in ds) for ds in dstates],
        tuple(t(s) for s in scal),
        [tuple(t(x) for x in dsc) for dsc in dscals], disk, adaptive,
        track,
    )
    return ([x.numpy() for x in new],
            [[x.numpy() for x in dn] for dn in dnews])


def _assert_step_matches(state, scal, dstates, dscals, disk, adaptive):
    ref, dref = _jax_step_jvp(state, scal, dstates, dscals, disk, adaptive)
    got, dgot = _torch_step_jvp(state, scal, dstates, dscals, disk, adaptive)
    assert len(got) == len(ref) == _K.N_STATE
    for slot, (g, r) in enumerate(zip(got, ref)):
        rtol, atol = TOLERANCE[slot]  # the forward step's primal contract
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg=f"primal slot {slot}")
    for k, (dg, dr) in enumerate(zip(dgot, dref)):
        for slot, (g, r) in enumerate(zip(dg, dr)):
            assert g.dtype == np.float32, slot
            if slot in _ZERO_TANGENT:
                assert not np.any(g) and not np.any(r), slot
                continue
            bound = _TANGENT_TOL[slot] * (np.abs(r) + np.abs(r).max())
            bad = ~(np.abs(g - r) <= bound)
            assert not bad.any(), (
                f"tangent {k} slot {slot}: {int(bad.sum())} rays, e.g. "
                f"got {g[bad][:3]} ref {r[bad][:3]}")
    return ref, dref


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "rkf45"])
@pytest.mark.parametrize("disk,incl", [(True, 0.0), (True, 0.3),
                                       (False, 0.0)],
                         ids=["disk", "disk-inclined", "no-disk"])
def test_step_update_jvp_matches_jax(adaptive, disk, incl):
    state, scal = _random_state(4096, seed=7 + int(adaptive), incl=incl)
    dstates, dscals = _tangents(state, seed=11 + int(adaptive))
    ref, _ = _assert_step_matches(state, scal, dstates, dscals, disk,
                                  adaptive)
    # The random states reach the step's decisions.
    codes = set(np.unique(ref[_K.S_RESULT][state[_K.S_RESULT] == -1.0]))
    assert {-1.0, 0.0, 3.0} <= codes


def _tie_state():
    """Rays built to land on the ties of the tangent rules inside the step:
    * the RK4 schedule clip(r / (7.5 rs), 0.05, 20) exactly at 0.05 (r =
      0.75) and at 20 (r = 300), M = 1;
    * equatorial rays in the disk's band with p_theta = 0: theta does not
      move, so the RKF45 error scale max(|c0|, |c5|) ties, |c5 - c4| is
      abs at 0, and the disk clamp's |z_new| is abs at 0;
    * retired rays, which do not advance: the chord is empty, so the
      frac guard |denom| < EPSILON and inv_len's max(step_len, EPSILON)
      take their constants."""
    n = 128
    state, scal = _random_state(n, seed=5, incl=0.0)
    state = [s.copy() for s in state]
    state[_K.S_RESULT][:] = -1.0
    state[_K.S_R][0:16] = 0.75
    state[_K.S_R][16:32] = 300.0
    eq = slice(32, 64)
    state[_K.S_R][eq] = np.linspace(7.0, 19.0, 32, dtype=np.float32)
    state[_K.S_TH][eq] = np.float32(np.pi / 2)
    state[_K.S_ST][eq] = 1.0
    state[_K.S_CT][eq] = 0.0
    state[_K.S_PTH][eq] = 0.0
    state[_K.S_RESULT][64:] = 3.0  # retired
    return state, scal


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "rkf45"])
def test_step_update_jvp_ties_match_jax(adaptive):
    state, scal = _tie_state()
    dstates, dscals = _tangents(state, seed=13)
    _assert_step_matches(state, scal, dstates, dscals, True, adaptive)
    ratio = (state[_K.S_R] / np.float32(7.5 * 2.0 * float(scal[0])))
    assert np.all(ratio[0:16] == np.float32(0.05))
    assert np.all(ratio[16:32] == np.float32(20.0))


def test_tie_rules_match_jax():
    """max, min, clip (constant and tensor bounds) and abs at ties, at
    NaN and off them: the port's helpers (tangent_rules) against
    jax.jvp."""
    nan = np.nan
    a = np.array([1.0, 2.0, 0.5, nan, 1.0, 0.0, -0.0, 5.0, 0.05, 20.0],
                 np.float32)
    b = np.array([1.0, 1.0, 3.0, 1.0, nan, 0.0, 2.0, 5.0, 0.05, 20.0],
                 np.float32)
    da = np.linspace(1.0, 2.0, a.size).astype(np.float32)
    db = np.linspace(-3.0, 4.0, a.size).astype(np.float32)
    K = tangent_rules
    cases = [
        (lambda x, y: jnp.maximum(x, y), lambda x, y: K.jmax(x, y)),
        (lambda x, y: jnp.minimum(x, y), lambda x, y: K.jmin(x, y)),
        (lambda x, y: jnp.maximum(x, 1.0), lambda x, y: K.jmax(x, 1.0)),
        (lambda x, y: jnp.clip(x, 0.05, 20.0),
         lambda x, y: K.jclip(x, 0.05, 20.0)),
        (lambda x, y: jnp.clip(x, y * 0.01, y),
         lambda x, y: K.jclip(x, y * 0.01, y)),
        (lambda x, y: jnp.abs(x) + y, lambda x, y: K.jabs(x) + y),
    ]
    for jf, tf in cases:
        ref = jax.jvp(jf, (jnp.asarray(a), jnp.asarray(b)),
                      (jnp.asarray(da), jnp.asarray(db)))
        got = torch.func.jvp(tf, (torch.from_numpy(a), torch.from_numpy(b)),
                             (torch.from_numpy(da), torch.from_numpy(db)))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_step_update_jvp_guard_rescale_and_scrub():
    """A tangent of magnitude 1e8 is rescaled to the 1e6 limit, direction
    kept; a NaN or Inf anywhere zeroes that ray's tangent.  The 1e8 sits
    on t, which feeds no other slot, so the largest slot (which sets the
    rescale factor of all of them) is one both sides compute alike."""
    state, scal = _random_state(256, seed=17, incl=0.0)
    dstates, dscals = _tangents(state, seed=19, n_tan=2)
    dstates[0][_K.S_T][:64] = 1e8
    # On slots every step carries on (t, dist), so the step keeps them.
    dstates[1][_K.S_T][64:96] = np.nan
    dstates[1][_K.S_DIST][96:128] = np.inf
    _, dref = _assert_step_matches(state, scal, dstates, dscals, True, False)
    mag = np.max(np.abs(np.stack(dref[0]))[:, :64], axis=0)
    np.testing.assert_allclose(mag, 1e6, rtol=1e-6)
    assert not np.any(np.stack(dref[1])[:, 64:128])


def test_tangent_guard_matches_jax():
    rng = np.random.default_rng(23)
    leaves = [rng.normal(0, 1e5, 300).astype(np.float32) for _ in range(5)]
    leaves[0][:20] = 3e7
    leaves[1][20:30] = np.nan
    leaves[2][30:40] = -np.inf
    leaves[3][40:50] = 1e6
    primals = tuple(np.ones(300, np.float32) for _ in leaves)
    _, ref = jax.jvp(lambda *t: jsens.tangent_guard(1, t),
                     tuple(jnp.asarray(p) for p in primals),
                     tuple(jnp.asarray(x) for x in leaves))
    prim, got = torch.func.jvp(
        lambda *t: sensitivity.tangent_guard(1, t),
        tuple(torch.from_numpy(p) for p in primals),
        tuple(torch.from_numpy(x) for x in leaves))
    for p in prim:
        assert torch.equal(p, torch.ones(300))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_clip_color_tangent_matches_jax():
    rng = np.random.default_rng(29)
    n = 200
    f32 = np.float32
    fields = {
        "result": np.zeros(n, np.int32), "steps": np.zeros(n, np.int32),
        "position": rng.normal(0, 1, (n, 3)).astype(f32),
        "sky_direction": rng.normal(0, 1, (n, 3)).astype(f32),
        "color": rng.uniform(0, 1, (n, 3)).astype(f32),
    }
    for name in ("distance", "time_dilation", "doppler", "temperature",
                 "redshift", "optical_depth", "min_r"):
        fields[name] = rng.uniform(0, 1, n).astype(f32)
    dcolor = rng.normal(0, 30, (n, 3)).astype(f32)
    from blackhole_tpu.geom.types import Hit as JHit

    jhit = JHit(**{k: jnp.asarray(v) for k, v in fields.items()})

    def jloss(color):
        h = jfast_grad.clip_color_tangent(
            jhit.__class__(**{**{k: getattr(jhit, k) for k in fields},
                              "color": color}))
        return jnp.sum(h.color * 2.0)

    ref = jax.jvp(jloss, (jnp.asarray(fields["color"]),),
                  (jnp.asarray(dcolor),))
    hit = Hit(**{k: torch.from_numpy(v) for k, v in fields.items()})

    def loss(color):
        h = fast_grad.clip_color_tangent(
            Hit(**{**vars(hit), "color": color}))
        return torch.sum(h.color * 2.0)

    got = torch.func.jvp(loss, (hit.color,), (torch.from_numpy(dcolor),))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)
    assert math.isclose(fast_grad.TANGENT_CLIP, jfast_grad.TANGENT_CLIP)
    # clip=None is the raw estimator; the primal is untouched either way.
    raw = torch.func.jvp(
        lambda c: torch.sum(fast_grad.clip_color_tangent(
            Hit(**{**vars(hit), "color": c}), None).color * 2.0),
        (hit.color,), (torch.from_numpy(dcolor),))
    np.testing.assert_allclose(float(raw[1]), 2.0 * dcolor.sum(), rtol=1e-5)
