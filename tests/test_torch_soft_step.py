"""The geodesic step with crossing-opacity tracking against the JAX package.

* step_update(..., track=True) (the plain version of the TRACK build of
  csrc/geodesic_step.cuh's step) against pallas_kernel._step_update(...,
  track=True), eagerly on the CPU: test_torch_step's random states with
  the 7 tracking slots appended (min |z'| in the disk's band, the
  position and the chord direction there), drawn so that the update
  fires on some near-disk states and is refused on others.  Tolerances:
  the step test's TOLERANCE for the 21 shared slots; min_az and the
  tracked position take the hit position's class, the tracked direction
  the last direction's.
* The jvp under the tangent guard: step_update_jvp(..., track=True)
  against jax.jvp of tangent_guard(2, _step_update(..., track,
  slave=True)), every primal and tangent slot, including a rescale led
  by a tracking slot (the guard spans all 28 slots).
The g++ twins of the TRACK build (K1 and Dual<2>) are cases of
test_torch_step.py's host-twin tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.render import pallas_kernel
from blackhole_tpu_torch.render import trace_kernel

from test_torch_fwdgrad_step import (
    _TANGENT_TOL, _ZERO_TANGENT, _tangents,
)
from test_torch_step import TOLERANCE, _random_state
import test_torch_fwdgrad_step as fwd

torch.set_num_threads(1)  # see tests/test_torch_step.py

_K = trace_kernel
# min_az and the tracked position: lengths, as the hit position; the
# tracked direction: the chord direction, as the last direction.
TRACK_TOLERANCE = {
    **TOLERANCE,
    **{s: TOLERANCE[_K.S_HX] for s in (_K.S_MINAZ, _K.S_GX, _K.S_GY,
                                       _K.S_GZ)},
    **{s: TOLERANCE[_K.S_LX] for s in (_K.S_GDX, _K.S_GDY, _K.S_GDZ)},
}
TRACK_TANGENT_TOL = {
    **_TANGENT_TOL,
    **{s: _TANGENT_TOL[_K.S_HX] for s in (_K.S_MINAZ, _K.S_GX, _K.S_GY,
                                          _K.S_GZ)},
    **{s: _TANGENT_TOL[_K.S_LX] for s in (_K.S_GDX, _K.S_GDY, _K.S_GDZ)},
}


def _track_state(n, seed, incl):
    """test_torch_step's random (state, scal) with the 7 tracking slots
    (the tests below draw the shared slots with the seeds of the
    non-tracking step tests):
    min_az far (1e9, the initial value) on a third of the states and a
    height up to 0.5 on the rest, so near-disk states (heights ~0.1-0.4
    above the plane) both take and refuse the update; the tracked
    position and direction random."""
    state, scal = _random_state(n, seed, incl)
    rng = np.random.default_rng(seed + 100)
    f = np.float32
    min_az = np.where(rng.random(n) < 1 / 3, 1e9,
                      rng.uniform(0.0, 0.5, n)).astype(f)
    gpos = rng.normal(0, 10, (3, n)).astype(f)
    gdir = rng.normal(0, 1, (3, n)).astype(f)
    return state + [min_az, *gpos, *gdir], scal


def _assert_primal(got, ref):
    assert len(got) == len(ref) == _K.N_STATE + _K.N_TRACK
    for slot, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == np.float32 == r.dtype, slot
        rtol, atol = TRACK_TOLERANCE[slot]
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg=f"slot {slot}")


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "rkf45"])
@pytest.mark.parametrize("incl", [0.0, 0.3], ids=["flat", "inclined"])
def test_step_update_track_matches_jax(adaptive, incl):
    state, scal = _track_state(4096, seed=3 + int(adaptive), incl=incl)
    ref = pallas_kernel._step_update(
        tuple(jnp.asarray(s) for s in state),
        tuple(jnp.asarray(s) for s in scal), True, adaptive, track=True,
    )
    got = trace_kernel.step_update(
        tuple(torch.from_numpy(s) for s in state),
        tuple(torch.from_numpy(s) for s in scal), True, adaptive, track=True,
    )
    _assert_primal([g.numpy() for g in got], [np.asarray(r) for r in ref])
    # The update both fires and is refused on active near-disk states.
    active = state[_K.S_RESULT] == -1.0
    moved = got[_K.S_MINAZ].numpy() != state[_K.S_MINAZ]
    assert (active & moved).sum() >= 50
    assert (active & ~moved & (state[_K.S_MINAZ] < 1.0)).sum() >= 50
    # Without tracking the 21 shared slots are the same step.
    plain = trace_kernel.step_update(
        tuple(torch.from_numpy(s) for s in state[:_K.N_STATE]),
        tuple(torch.from_numpy(s) for s in scal), True, adaptive)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _assert_jvp(state, scal, dstates, dscals, adaptive):
    ref, dref = fwd._jax_step_jvp(state, scal, dstates, dscals, True,
                                  adaptive, track=True)
    got, dgot = fwd._torch_step_jvp(state, scal, dstates, dscals, True,
                                    adaptive, track=True)
    _assert_primal(got, ref)
    for k, (dg, dr) in enumerate(zip(dgot, dref)):
        assert len(dg) == len(dr) == _K.N_STATE + _K.N_TRACK
        for slot, (g, r) in enumerate(zip(dg, dr)):
            assert g.dtype == np.float32, slot
            if slot in _ZERO_TANGENT:
                assert not np.any(g) and not np.any(r), slot
                continue
            bound = TRACK_TANGENT_TOL[slot] * (np.abs(r) + np.abs(r).max())
            bad = ~(np.abs(g - r) <= bound)
            assert not bad.any(), (
                f"tangent {k} slot {slot}: {int(bad.sum())} rays, e.g. "
                f"got {g[bad][:3]} ref {r[bad][:3]}")
    return ref, dref


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "rkf45"])
def test_step_update_track_jvp_matches_jax(adaptive):
    state, scal = _track_state(4096, seed=7 + int(adaptive), incl=0.3)
    dstates, dscals = _tangents(state, seed=11 + int(adaptive),
                                n_slots=len(state))
    ref, _ = _assert_jvp(state, scal, dstates, dscals, adaptive)
    active = state[_K.S_RESULT] == -1.0
    assert (active & (ref[_K.S_MINAZ] != state[_K.S_MINAZ])).sum() >= 20


def test_step_update_track_guard_led_by_a_tracking_slot():
    """A tangent of 1e8 on the tracked direction, on states whose min_az
    is 0 (no sampled height is below it, so the slot is carried through
    the step unchanged), is the largest of its ray's 28 slots: the guard
    rescales every slot of the ray by 1e6 / 1e8 (a guard over the first
    21 slots would leave them alone, and this slot at 1e8)."""
    state, scal = _track_state(256, seed=17, incl=0.0)
    state[_K.S_MINAZ][:64] = 0.0
    dstates, dscals = _tangents(state, seed=19, n_tan=2, n_slots=len(state))
    dstates[0][_K.S_GDX][:64] = 1e8
    _, dref = _assert_jvp(state, scal, dstates, dscals, False)
    d0 = np.abs(np.stack(dref[0]))[:, :64]
    np.testing.assert_allclose(d0.max(axis=0), 1e6, rtol=1e-6)
    np.testing.assert_allclose(d0[_K.S_GDX], 1e6, rtol=1e-6)
