"""Reverse-mode rules of the PyTorch port against jax.grad and jax.vjp.

The port's custom autograd Functions follow JAX's derivative rules in
reverse mode too: max, min, clip and abs at ties (tangent_rules), the
trig slaving's transpose (render.trace), and the cotangent guard
(integrate.sensitivity).  .backward() through the modules that take
them (event_horizon, the capture margin, unpack_params) gives jax.grad's
gradient, float64.  The forward-mode-only identities (tangent_guard,
fast_grad.clip_color_tangent) raise in reverse mode, as jax.grad through
their JAX twins does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.grad import fast_grad as jfast
from blackhole_tpu.grad import inverse as jinverse
from blackhole_tpu.integrate import sensitivity as jsens
from blackhole_tpu.metrics import derived as jderived
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import trace as jtrace
from blackhole_tpu_torch import tangent_rules
from blackhole_tpu_torch.geom.types import (
    Hit, camera_from_reference, params_from_reference, scene_from_reference,
)
from blackhole_tpu_torch.grad import fast_grad, inverse
from blackhole_tpu_torch.integrate import sensitivity
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, trace

torch.set_num_threads(1)  # see tests/test_torch_step.py

F64 = torch.float64


def _grad(fn, *xs):
    xs = [torch.tensor(x, dtype=F64, requires_grad=True) for x in xs]
    fn(*xs).sum().backward()
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("op", ["max", "min", "clip", "abs"])
def test_tie_rules_match_jax_grad(op):
    """Gradients at ties, at NaN and away from them: jmax / jmin against
    jnp.maximum / minimum (both operands tensors, and a float bound),
    jclip against jnp.clip at both bounds, jabs against jnp.abs at 0."""
    x = np.array([-2.0, -1.0, 0.0, 0.5, 1.0, 3.0, np.nan])
    y = np.array([-2.0, 0.0, 0.0, 1.0, 1.0, 2.0, 0.0])
    if op in ("max", "min"):
        t_fn = tangent_rules.jmax if op == "max" else tangent_rules.jmin
        j_fn = jnp.maximum if op == "max" else jnp.minimum
        got = _grad(t_fn, x, y)
        want = jax.grad(lambda a, b: j_fn(a, b).sum(), (0, 1))(x, y)
        got_f = _grad(lambda a: t_fn(a, 1.0), x)
        want_f = jax.grad(lambda a: j_fn(a, 1.0).sum())(x)
        pairs = list(zip(got, want)) + [(got_f[0], want_f)]
    elif op == "clip":
        got = _grad(lambda a: tangent_rules.jclip(a, -1.0, 1.0), x)
        want = jax.grad(lambda a: jnp.clip(a, -1.0, 1.0).sum())(x)
        pairs = [(got[0], want)]
        assert got[0][1] == 0.5 and got[0][4] == 0.5  # torch.clamp: 1
    else:
        got = _grad(tangent_rules.jabs, x)
        want = jax.grad(lambda a: jnp.abs(a).sum())(x)
        pairs = [(got[0], want)]
        assert got[0][2] == 1.0  # torch.abs: 0
    for g, w in pairs:
        np.testing.assert_array_equal(g, np.asarray(w))


def test_max_broadcast_cotangent_sums_to_the_operand():
    """A 0-d operand broadcast against per-ray values gets the sum of its
    share, as jax.grad gives."""
    x = np.array([0.5, 1.0, 2.0, 1.0])
    got = _grad(tangent_rules.jmax, x, 1.0)
    want = jax.grad(lambda a, b: jnp.maximum(a, b).sum(), (0, 1))(
        x, np.float64(1.0))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_slave_trig_transpose_matches_jax_vjp():
    """trace.slave_trig_tangent's backward against jax.vjp through
    trace.slave_trig_tangent: the trig cotangents move to theta and phi,
    the trig slots get none."""
    rng = np.random.default_rng(0)
    y = rng.normal(0, 1, (32, 10))
    ct = rng.normal(0, 1, (32, 10))
    _, vjp = jax.vjp(jtrace.slave_trig_tangent, jnp.asarray(y))
    (want,) = vjp(jnp.asarray(ct))
    yt = torch.tensor(y, requires_grad=True)
    out = trace.slave_trig_tangent(yt)
    np.testing.assert_array_equal(out.detach().numpy(), y)
    out.backward(torch.tensor(ct))
    np.testing.assert_allclose(yt.grad.numpy(), want, rtol=1e-15,
                               atol=1e-15)
    assert not yt.grad[:, geodesic.IST:].any()


def test_event_horizon_backward_matches_jax():
    """.backward() through event_horizon: d r+/d M at (1.0, 0.9, 0.0) is
    1.4359 (jax.grad), and the a = M tie of the radicand's max."""
    for args in ((1.0, 0.9, 0.0), (1.0, 1.0, 0.0), (1.3, 0.5, 0.2)):
        got = _grad(derived.event_horizon, *args)
        want = jax.grad(jderived.event_horizon, (0, 1, 2))(*args)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    assert _grad(derived.event_horizon, 1.0, 0.9, 0.0)[0] == \
        pytest.approx(1.4359, abs=1e-4)


def _soft_case():
    scene = jtypes.Scene(
        jtypes.BlackHole.create(1.0, 0.9, 0.1, dtype=jnp.float64),
        jtypes.Disk.create(6.0, 20.0, dtype=jnp.float64),
        jtypes.SimConfig.create(shadow_softness=0.3, dtype=jnp.float64))
    camera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                  direction=(0.0, 30.0, -8.0),
                                  up=(0.0, 0.0, 1.0), fov_deg=25.0,
                                  dtype=jnp.float64)
    o, d = jcam.generate_rays(camera, 8, 8)
    return scene, camera, np.asarray(o).reshape(-1, 3), \
        np.asarray(d).reshape(-1, 3)


def test_capture_margin_backward_matches_jax():
    """.backward() of the summed capture margin over valid rays through
    trace.compute_capture_margin, d/d(mass, spin, charge) and d/d(rays),
    float64."""
    scene, _, o, d = _soft_case()

    def jloss(m, s, q, o_, d_):
        sc = dataclasses.replace(scene, blackhole=jtypes.BlackHole(m, s, q))
        margin, valid = jtrace.compute_capture_margin(o_, d_, sc)
        return jnp.where(valid, margin, 0.0).sum()

    want = jax.grad(jloss, (0, 1, 2, 3, 4))(1.0, 0.9, 0.1, o, d)
    tscene = scene_from_reference(scene, device="cpu", dtype=F64)
    xs = [torch.tensor(v, dtype=F64, requires_grad=True)
          for v in (1.0, 0.9, 0.1, o, d)]
    sc = dataclasses.replace(tscene, blackhole=dataclasses.replace(
        tscene.blackhole, mass=xs[0], spin=xs[1], charge=xs[2]))
    margin, valid = trace.compute_capture_margin(xs[3], xs[4], sc)
    assert bool(valid.any())
    torch.where(valid, margin, 0.0).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=1e-9, atol=1e-12)


def test_unpack_params_backward_matches_jax():
    """.backward() through unpack_params (with _charge_budget's max),
    of a sum over the unpacked scene's and camera's leaves, against
    jax.grad, from params_from_reference of the JAX pack_params."""
    scene, camera, _, _ = _soft_case()
    jparams = jinverse.pack_params(scene, camera)

    def jloss(p):
        s, c = jinverse.unpack_params(p, scene, camera)
        bh, dk = s.blackhole, s.disk
        return (bh.mass + 2 * bh.spin + 3 * bh.charge + dk.inner_radius
                + dk.outer_radius + dk.temperature_scale + c.fov_deg
                + c.position.sum())

    want = jax.grad(jloss)(jparams)
    tscene = scene_from_reference(scene, device="cpu", dtype=F64)
    tcam = camera_from_reference(camera, device="cpu", dtype=F64)
    params = params_from_reference(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=F64)
    for k, v in inverse.pack_params(tscene, tcam).items():
        np.testing.assert_allclose(v.numpy(), params[k].numpy(), rtol=1e-15)
    for v in params.values():
        v.requires_grad_(True)
    s, c = inverse.unpack_params(params, tscene, tcam)
    bh, dk = s.blackhole, s.disk
    (bh.mass + 2 * bh.spin + 3 * bh.charge + dk.inner_radius
     + dk.outer_radius + dk.temperature_scale + c.fov_deg
     + c.position.sum()).backward()
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[k]),
                                   rtol=1e-12, err_msg=k)


def test_cotangent_guard_rescales_planted_overflow():
    """cotangent_guard is an identity whose backward rescales each ray's
    cotangent to TANGENT_LIMIT over all its leaves and zeroes a ray with
    a non-finite one, as the JAX package's custom_vjp does."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (6, 4))
    b = rng.normal(0, 1, (6,))
    ga = rng.normal(0, 10, (6, 4))
    gb = rng.normal(0, 10, (6,))
    ga[0, 2] = 5e8          # overflowing slot: ray 0 rescaled as a whole
    gb[1] = -3e7            # the other leaf sets ray 1's magnitude
    ga[2, 0] = np.inf       # non-finite: ray 2 zeroed
    gb[3] = np.nan
    _, vjp = jax.vjp(lambda t: jsens.cotangent_guard(1, t),
                     (jnp.asarray(a), jnp.asarray(b)))
    (want,) = vjp((jnp.asarray(ga), jnp.asarray(gb)))
    at = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    out = sensitivity.cotangent_guard(1, (at, bt))
    np.testing.assert_array_equal(out[0].detach().numpy(), a)
    torch.autograd.backward(out, (torch.tensor(ga), torch.tensor(gb)))
    np.testing.assert_allclose(at.grad.numpy(), want[0], rtol=1e-15)
    np.testing.assert_allclose(bt.grad.numpy(), want[1], rtol=1e-15)
    assert at.grad[0, 2] == pytest.approx(sensitivity.TANGENT_LIMIT)
    assert not at.grad[2:4].any() and not bt.grad[2:4].any()
    np.testing.assert_array_equal(at.grad[4:].numpy(), ga[4:])


def test_forward_only_identities_raise_in_reverse_mode():
    """tangent_guard and clip_color_tangent have forward-mode rules only;
    jax.grad through their JAX twins raises, and so does .backward()."""
    x = np.linspace(0.1, 1.0, 4)
    with pytest.raises(Exception):
        jax.grad(lambda t: jsens.tangent_guard(1, (t,))[0].sum())(x)
    jhit = jtypes.Hit(*([jnp.asarray(x)] * 12))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda t: jfast.clip_color_tangent(
            dataclasses.replace(jhit, color=t)).color.sum())(x)
    xt = torch.tensor(x, requires_grad=True)
    with pytest.raises(NotImplementedError):
        sensitivity.tangent_guard(1, (xt,))[0].sum().backward()
    hit = Hit(*([torch.tensor(x)] * 12))
    with pytest.raises(NotImplementedError):
        fast_grad.clip_color_tangent(
            dataclasses.replace(hit, color=xt)).color.sum().backward()
