"""The XLA engine of the PyTorch port against the JAX package.

The steppers, geodesic.rhs_aug and the image module's XLA-engine entry
points, and trace.trace_rays itself (through image.trace_rays_fast with
engine="xla") against the JAX package's trace.trace_rays, on the same
float32 rays made from a seed, under the parity contracts of the JAX
package's engine checks:
  RK4 (and the symplectic integrators, fixed-step as RK4): result codes
    and steps equal, colour max < 2e-4 over agreeing rays that are not
    MAX_STEPS;
  RKF45: at most n/500 result codes differ, colour mean < 2e-3 and
    p99 < 3e-2 over agreeing non-MAX_STEPS rays (the controller's
    accept/reject turns an ulp of pow or log rounding into another step
    sequence).
Forward mode through the engine (torch.func.jvp against jax.jvp) and
its tangent guard, whose magnitude spans the carried L's tangent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.integrate import sensitivity as jsens
from blackhole_tpu.integrate import steppers as jsteppers
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import geodesic as jgeo
from blackhole_tpu.render import image as jimage
from blackhole_tpu.render import trace as jtrace
from blackhole_tpu_torch.geom.types import (
    RayResult, camera_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.integrate import sensitivity, steppers
from blackhole_tpu_torch.render import geodesic, image, trace

torch.set_num_threads(1)  # see tests/test_torch_step.py

F32 = np.float32


def _case(integrator="rk4", spin=0.9, disk=True, softness=0.0,
          max_steps=250, time_step=0.1, size=32):
    scene = jtypes.Scene(
        jtypes.BlackHole.create(1.0, spin),
        jtypes.Disk.create(6.0, 20.0),
        jtypes.SimConfig.create(time_step=time_step, max_ray_distance=80.0,
                                max_steps=max_steps, integrator=integrator,
                                shadow_softness=softness),
        disk_enabled=disk,
    )
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0)
    o, d = jcam.generate_rays(camera, size, size)
    return (scene, camera, np.array(o, F32).reshape(-1, 3),
            np.array(d, F32).reshape(-1, 3))


def _assert_contract(got, ref, adaptive):
    res, res_ref = got.result.numpy(), np.asarray(ref.result)
    agree = res == res_ref
    dc = np.abs(got.color.numpy() - np.asarray(ref.color)).max(-1)
    mask = agree & (res_ref != RayResult.MAX_STEPS)
    dc = dc[mask] if mask.any() else dc
    if adaptive:
        assert np.sum(~agree) <= max(1, res.size // 500)
        assert dc.mean() < 2e-3 and np.percentile(dc, 99) < 3e-2
    else:
        np.testing.assert_array_equal(res, res_ref)
        np.testing.assert_array_equal(got.steps.numpy(),
                                      np.asarray(ref.steps))
        assert dc.max() < 2e-4


def test_steppers_match_jax():
    """rk4_step, rkf45_step (with n_err), rkf45_next_h, leapfrog_step and
    yoshida4_step on a damped oscillator field, float32."""
    rng = np.random.default_rng(0)
    y = rng.normal(0, 1, (64, 10)).astype(F32)
    h = rng.uniform(0.01, 0.3, (64, 1)).astype(F32)
    w = rng.uniform(0.5, 2.0, (64,)).astype(F32)

    def field(xp):
        def f(t, y_, w_):
            return xp.stack([y_[..., (i + 1) % 10] * w_ - 0.1 * y_[..., i]
                             for i in range(10)], -1)
        return f

    tj = [jnp.asarray(x) for x in (y, h, w)]
    tt = [torch.from_numpy(x) for x in (y, h, w)]
    np.testing.assert_allclose(
        steppers.rk4_step(field(torch), 0.0, tt[0], tt[1], tt[2]).numpy(),
        jsteppers.rk4_step(field(jnp), 0.0, *tj), rtol=1e-6, atol=1e-6)
    for n_err in (None, 6):
        y5, err = steppers.rkf45_step(field(torch), 0.0, *tt, n_err=n_err)
        y5j, errj = jsteppers.rkf45_step(field(jnp), 0.0, *tj, n_err=n_err)
        np.testing.assert_allclose(y5.numpy(), y5j, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(err.numpy(), errj, rtol=1e-4, atol=1e-9)
    ratio = np.concatenate([rng.uniform(0, 4, 62), [0.0, 1e-40]]).astype(F32)
    acc = ratio <= 1.0
    np.testing.assert_allclose(
        steppers.rkf45_next_h(tt[1][:, 0], torch.from_numpy(ratio),
                              torch.from_numpy(acc)).numpy(),
        jsteppers.rkf45_next_h(tj[1][:, 0], jnp.asarray(ratio),
                               jnp.asarray(acc)), rtol=2e-6)

    def accel(xp):
        def a(t, x, v, w_):
            return -x * w_[..., None] - 0.05 * v
        return a

    x, v = y[:, :5], y[:, 5:]
    for port, ref in ((steppers.leapfrog_step, jsteppers.leapfrog_step),
                      (steppers.yoshida4_step, jsteppers.yoshida4_step)):
        got = port(accel(torch), 0.0, torch.from_numpy(x),
                   torch.from_numpy(v), tt[1], tt[2])
        want = ref(accel(jnp), 0.0, jnp.asarray(x), jnp.asarray(v), tj[1],
                   tj[2])
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("charge", [0.0, 0.3])
def test_rhs_aug_and_hamiltonian_match_jax(charge):
    """rhs_aug, rhs and the Hamiltonian at states along the parity
    camera's initial rays, spin 0.9."""
    _, _, o, d = _case(size=16)
    M, a = 1.0, 0.9
    yj, _, Lj, _ = jgeo.init_null_rays_aug(jnp.asarray(o), jnp.asarray(d),
                                           M, a, charge)
    y = torch.from_numpy(np.array(yj))
    L = torch.from_numpy(np.array(Lj))
    rng = np.random.default_rng(1)
    # Move the states inward so the strong-field terms matter.
    y[:, 0] = torch.from_numpy(rng.uniform(2.5, 25.0, y.shape[0]).astype(F32))
    yj = jnp.asarray(y.numpy())
    np.testing.assert_allclose(
        geodesic.rhs_aug(y, 1.0, L, M, a, charge).numpy(),
        jgeo.rhs_aug(yj, 1.0, Lj, M, a, charge), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        geodesic.rhs(y[:, :6], 1.0, L, M, a, charge).numpy(),
        jgeo.rhs(yj[:, :6], 1.0, Lj, M, a, charge), rtol=2e-5, atol=2e-6)
    args = (y[:, 0], y[:, 1], y[:, 3], y[:, 4], 1.0, L, M, a, charge)
    jargs = (yj[:, 0], yj[:, 1], yj[:, 3], yj[:, 4], 1.0, Lj, M, a, charge)
    np.testing.assert_allclose(geodesic.hamiltonian(*args).numpy(),
                               jgeo.hamiltonian(*jargs), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize(
    "integrator,spin,disk,softness",
    [("rk4", 0.9, True, 0.0), ("rk4", 0.0, False, 0.0),
     ("rk4", 0.9, True, 0.3), ("rkf45", 0.9, True, 0.0),
     ("rkf45", 0.0, False, 0.0), ("leapfrog", 0.9, True, 0.0),
     ("yoshida", 0.9, True, 0.0)],
    ids=["rk4-disk", "rk4-no-disk", "rk4-disk-track", "rkf45-disk",
         "rkf45-no-disk", "leapfrog", "yoshida"])
def test_trace_rays_xla_matches_jax(integrator, spin, disk, softness):
    """trace_rays_fast(engine="xla") against trace.trace_rays at 32x32;
    the wide step (0.5) reaches captures, the disk and the budget."""
    scene, _, o, d = _case(integrator, spin, disk, softness, time_step=0.5)
    ref = jtrace.trace_rays(jnp.asarray(o), jnp.asarray(d), scene)
    tscene = scene_from_reference(scene, device="cpu")
    got = image.trace_rays_fast(torch.from_numpy(o), torch.from_numpy(d),
                                tscene, engine="xla")
    assert got.result.dtype == torch.int32 and got.color.shape == (1024, 3)
    _assert_contract(got, ref, adaptive=integrator == "rkf45")
    codes = set(np.asarray(ref.result).tolist())
    assert RayResult.HORIZON in codes and (RayResult.DISK in codes) == disk
    if integrator in ("leapfrog", "yoshida"):
        # "auto" takes the XLA engine for the symplectic integrators.
        again = image.trace_rays_fast(torch.from_numpy(o),
                                      torch.from_numpy(d), tscene)
        np.testing.assert_array_equal(again.color.numpy(),
                                      got.color.numpy())


def test_unknown_engine_raises():
    scene, _, o, d = _case(max_steps=4, size=4)
    with pytest.raises(ValueError):
        image.trace_rays_fast(torch.from_numpy(o), torch.from_numpy(d),
                              scene_from_reference(scene, device="cpu"),
                              engine="pallas")


def test_tangent_guard_spans_L():
    """guard_carry(tangent_guard) against the JAX package's tangent_guard
    over a TraceCarry under jax.jvp: rays whose only large tangent is L's
    are rescaled as a whole, rays with a non-finite tangent zeroed."""
    rng = np.random.default_rng(2)
    n = 16
    fields = {"y": (n, 10), "h": (n,), "L": (n,), "dist": (n,),
              "hit_pos": (n, 3), "last_dir": (n, 3), "min_r": (n,)}
    prim = {k: rng.normal(0, 1, s).astype(F32) for k, s in fields.items()}
    tan = {k: rng.normal(0, 10, s).astype(F32) for k, s in fields.items()}
    tan["L"][:4] = [3e6, -5e7, 1e8, 2e6]
    tan["y"][5, 3] = np.inf
    tan["L"][6] = np.nan

    def carry(xp, vals):
        ints = xp.zeros((n,), dtype=xp.int32)
        return dict(vals, steps=ints, result=ints - 1)

    jprim = jtrace.TraceCarry(**carry(jnp, {k: jnp.asarray(v)
                                            for k, v in prim.items()}),
                              iter=jnp.int32(0))
    jtan = jtrace.TraceCarry(
        **{k: jnp.asarray(v) for k, v in tan.items()},
        steps=np.zeros((n,), jax.dtypes.float0),
        result=np.zeros((n,), jax.dtypes.float0),
        iter=np.zeros((), jax.dtypes.float0))
    _, jout = jax.jvp(lambda c: jsens.tangent_guard(1, c), (jprim,), (jtan,))

    tprim = trace.TraceCarry(**carry(torch, {k: torch.from_numpy(v)
                                             for k, v in prim.items()}),
                             iter=0)
    names = list(fields)

    def f(*xs):
        c = tprim._replace(**dict(zip(names, xs)))
        g = trace.guard_carry(c, sensitivity.tangent_guard)
        return tuple(getattr(g, k) for k in names)

    _, tout = torch.func.jvp(f, tuple(getattr(tprim, k) for k in names),
                             tuple(torch.from_numpy(tan[k]) for k in names))
    for k, t in zip(names, tout):
        np.testing.assert_allclose(t.numpy(), getattr(jout, k), rtol=1e-6,
                                   atol=1e-30, err_msg=k)
    # Ray 0's y tangent was scaled by L's magnitude alone (3e6); the
    # rays with a non-finite slot lost their whole tangent.
    np.testing.assert_allclose(tout[0][0].numpy(), tan["y"][0] / 3.0,
                               rtol=1e-6)
    assert float(tout[0][5:7].abs().max()) == 0.0


def test_jvp_through_xla_engine_matches_jax():
    """torch.func.jvp of the colours through trace.trace_rays against
    jax.jvp through the JAX package's, d/dmass, at 16x16, spin 0.9,
    RK4, 120 steps at the wide step (the tangent guard in the loop)."""
    scene, _, o, d = _case(max_steps=120, time_step=0.5, size=16)
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    def jcol(m):
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m))
        return jtrace.trace_rays(oj, dj, s).color

    jc, jdc = jax.jvp(jcol, (jnp.float32(1.0),), (jnp.float32(1.0),))
    tscene = scene_from_reference(scene, device="cpu")
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)

    def tcol(m):
        s = dataclasses.replace(tscene, blackhole=dataclasses.replace(
            tscene.blackhole, mass=m))
        return trace.trace_rays(ot, dt, s).color

    c, dc = torch.func.jvp(tcol, (torch.tensor(1.0),), (torch.tensor(1.0),))
    np.testing.assert_allclose(c.numpy(), jc, atol=2e-4)
    # Per ray: the tangents of rays off the photon shell; whole: the mean.
    np.testing.assert_allclose(float(dc.mean()), float(jdc.mean()),
                               rtol=1e-3)
    gap = np.abs(dc.numpy() - np.asarray(jdc)).max(-1)
    assert np.median(gap) < 1e-4


def test_render_entry_points_match_jax():
    """render_image with chunks, render_hits, render_accumulated and
    predicted_depth_order_rays against the JAX package's (XLA engine;
    the prepass of the depth order through the kernel's plain version
    against the JAX package's kernel in interpret mode)."""
    scene, camera, o, d = _case(max_steps=60, time_step=0.5, size=16)
    tscene = scene_from_reference(scene, device="cpu")
    tcam = camera_from_reference(camera, device="cpu")
    img = image.render_image(tscene, tcam, 16, 12, chunks=4, engine="xla")
    ref = jimage.render_image(scene, camera, 16, 12, chunks=4, engine="xla")
    np.testing.assert_allclose(img.numpy(), ref, atol=2e-4)
    # Unchunked, every ray takes the steps of the slowest: frozen rays'
    # trig is renormalised once per extra step, an ulp of colour.
    one = image.render_image(tscene, tcam, 16, 12, engine="xla")
    np.testing.assert_allclose(one.numpy(), img.numpy(), atol=1e-6)
    hits = image.render_hits(tscene, tcam, 8, 6)
    jhits = jimage.render_hits(scene, camera, 8, 6)
    assert hits.result.shape == (6, 8)
    np.testing.assert_array_equal(hits.result.numpy(), jhits.result)
    np.testing.assert_allclose(hits.color.numpy(), jhits.color, atol=2e-4)
    acc = image.render_accumulated(tscene, tcam, 8, 6, n_frames=3)
    jacc = jimage.render_accumulated(scene, camera, 8, 6, n_frames=3)
    np.testing.assert_allclose(acc.numpy(), jacc, atol=2e-4)
    order = image.predicted_depth_order_rays(torch.from_numpy(o),
                                             torch.from_numpy(d), tscene,
                                             stride=8)
    jorder = jimage.predicted_depth_order_rays(jnp.asarray(o),
                                               jnp.asarray(d), scene,
                                               stride=8, interpret=True)
    np.testing.assert_array_equal(order.numpy(), jorder)
