"""The soft boundary's modules in the PyTorch port against the JAX package.

Value and jvp (torch.func.jvp against jax.jvp, the same tangent
directions) of:
* metrics.derived: event_horizon, kerr_radial_potential and
  capture_margin_length with respect to L, Qc, M and a, on the conserved
  quantities of camera rays, critical ones, and a ray with no barrier
  (its Newton iterate pins at the horizon clamp);
* render.trace.compute_capture_margin (and its primal-only valid mask)
  and render.shading.disk_edge_window;
* render.trace.finalize with tracking planes and a margin: every field of
  the Hit, and the colour's tangent along the mass, the tracked height,
  position and direction, min_r and the margin.
Both sides compute in float32; the tolerances are stated per case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.metrics import derived as jderived
from blackhole_tpu.render import geodesic as jgeo
from blackhole_tpu.render import shading as jshading
from blackhole_tpu.render import trace as jtrace
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import scene_from_reference
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, shading, trace

torch.set_num_threads(1)  # see tests/test_torch_step.py

F32 = np.float32


def _t(x):
    return torch.from_numpy(np.array(x, F32))


def _j(x):
    return jnp.asarray(np.array(x, F32))


def _close(got, ref, rtol, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def _rays(n, seed):
    """Camera rays around the hole from (0, -35, 12), some aimed near the
    shadow's edge, some away."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, -35.0, 12.0], F32), (n, 1))
    aim = rng.normal(0, 7.0, (n, 3)) - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(F32)
    d[: n // 8] *= -1.0  # outgoing
    return o, d


def _conserved(o, d, M, a):
    """(L, Qc) of the rays from the JAX package's null initialisation."""
    _, _, L, Qc = jgeo.init_null_rays_aug(_j(o), _j(d), jnp.float32(M),
                                          jnp.float32(a * M),
                                          jnp.float32(0.0))
    return np.asarray(L, F32), np.asarray(Qc, F32)


def test_event_horizon_and_radial_potential_match_jax():
    rng = np.random.default_rng(1)
    M = rng.uniform(0.5, 2.0, 300).astype(F32)
    spin = rng.uniform(-1.0, 1.0, 300).astype(F32)
    spin[:10] = 1.0  # extremal: the radicand at 0
    q = rng.uniform(0.0, 0.3, 300).astype(F32)
    args_t, args_j = (_t(M), _t(spin), _t(q)), (_j(M), _j(spin), _j(q))
    dirs = [rng.normal(0, 1, 300).astype(F32) for _ in range(3)]
    got = torch.func.jvp(derived.event_horizon, args_t,
                         tuple(_t(x) for x in dirs))
    ref = jax.jvp(jderived.event_horizon, args_j, tuple(_j(x) for x in dirs))
    _close(got[0], ref[0], 1e-6, 1e-6, "r+")
    # d sqrt at a zero radicand: jnp.maximum's clamped branch, both inf
    # or both finite.
    _close(got[1], ref[1], 1e-5, 1e-5, "dr+")

    r = rng.uniform(1.5, 60.0, 300).astype(F32)
    L = rng.normal(0, 5.0, 300).astype(F32)
    Qc = rng.uniform(-5.0, 40.0, 300).astype(F32)
    a = (spin * M).astype(F32)
    xs = (r, L, Qc, M, a, q)
    dirs = [rng.normal(0, 1, 300).astype(F32) for _ in xs]
    got = torch.func.jvp(derived.kerr_radial_potential,
                         tuple(_t(x) for x in xs), tuple(_t(x) for x in dirs))
    ref = jax.jvp(jderived.kerr_radial_potential, tuple(_j(x) for x in xs),
                  tuple(_j(x) for x in dirs))
    # A quartic in r up to 60: float32 cancellation at 1e7 scale.
    scale = np.abs(np.asarray(ref[0])).max()
    _close(got[0], ref[0], 1e-5, 1e-6 * scale, "R")
    _close(got[1], ref[1], 1e-5, 1e-6 * np.abs(np.asarray(ref[1])).max(),
           "dR")


def test_capture_margin_length_matches_jax():
    """Camera rays of the a = 0.9 hole, plus a radially infalling ray with
    no barrier (L = 0, Qc = 0.5: p1 > 0, the iterate pins at 1.01 r+ and
    the ray is captured), value and jvp along random directions in (L, Qc,
    M, a).  Tolerance: the margin is sqrt(2 |R(r*)| / R''(r*)) after 16
    Newton steps, with |R| a float32 difference at 1e4 scale: rtol 1e-4
    and atol 1e-3 on values up to ~10 (measured 2e-5); its tangent
    diverges like 1 / margin at criticality, held to 1e-3 of |ref| plus
    1e-4 of the largest |ref|."""
    M, spin = 1.0, 0.9
    o, d = _rays(512, seed=2)
    L, Qc = _conserved(o, d, M, spin)
    L = np.append(L, F32(0.0))
    Qc = np.append(Qc, F32(0.5))
    n = L.size
    Ms = np.full(n, M, F32)
    As = np.full(n, spin * M, F32)
    rng = np.random.default_rng(3)
    dirs = [rng.normal(0, 1, n).astype(F32) for _ in range(4)]
    xs = (L, Qc, Ms, As)

    got = torch.func.jvp(derived.capture_margin_length,
                         tuple(_t(x) for x in xs), tuple(_t(x) for x in dirs))
    ref = jax.jvp(jderived.capture_margin_length, tuple(_j(x) for x in xs),
                  tuple(_j(x) for x in dirs))
    _close(got[0], ref[0], 1e-4, 1e-3, "margin")
    dref = np.asarray(ref[1])
    dgot = got[1].numpy()
    bound = 1e-3 * np.abs(dref) + 1e-4 * np.abs(dref).max()
    assert np.all(np.abs(dgot - dref) <= bound), "dmargin"
    # Both signs occur, and the ray without a barrier is captured.
    m = got[0].numpy()
    assert (m > 0).sum() > 10 and (m < 0).sum() > 10
    assert m[-1] > 0


def _soft_scene(mass=1.0, spin=0.9, incl=0.0):
    return jtypes.Scene(
        jtypes.BlackHole.create(mass, spin),
        jtypes.Disk.create(6.0, 20.0, inclination=incl),
        jtypes.SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                                max_steps=300, shadow_softness=0.3),
        disk_enabled=True,
    )


def _with_mass(scene, mass):
    return dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=mass))


def test_compute_capture_margin_and_edge_window_match_jax():
    """compute_capture_margin from rays: margin (value and jvp along the
    ray directions and the mass) and valid equal; disk_edge_window on
    points around the annulus's edges, value and jvp along the points, at
    two inclinations.  Tolerances as capture_margin_length's; the window
    rtol 1e-5, atol 1e-6."""
    o, d = _rays(512, seed=4)
    rng = np.random.default_rng(5)
    dd = rng.normal(0, 0.01, d.shape).astype(F32)
    jscene = _soft_scene()
    tscene = scene_from_reference(jscene, device="cpu")

    def jf(m, d_):
        return jtrace.compute_capture_margin(_j(o), d_, _with_mass(jscene,
                                                                   m))[0]

    def tf(m, d_):
        return trace.compute_capture_margin(_t(o), d_, _with_mass(tscene,
                                                                  m))[0]

    ref = jax.jvp(jf, (jnp.float32(1.0), _j(d)), (jnp.float32(1.0), _j(dd)))
    got = torch.func.jvp(tf, (torch.tensor(1.0), _t(d)),
                         (torch.tensor(1.0), _t(dd)))
    # The two null initialisations give (L, Qc) a few ulp apart (Qc to
    # 1e-4 relative: a cancellation), and the margin of a ray captured
    # far inside the barrier, whose potential has no sharp dip, moves by
    # up to 30% under that (5 of 512 rays, margins 1.8 to 15).  Such rays
    # are dark: survival sigmoid(-margin / (0.3 M) - 3) < 3e-4 from
    # margin 1.5.  Compared: the rays below that; the rest must agree in
    # sign.
    m_ref, dref = np.asarray(ref[0]), np.asarray(ref[1])
    live = m_ref < 1.5
    assert live.sum() > 400 and np.all(got[0].numpy()[~live] > 0)
    _close(got[0][live], m_ref[live], 1e-4, 1e-3, "margin")
    dref = dref[live]
    bound = 1e-3 * np.abs(dref) + 1e-4 * np.abs(dref).max()
    assert np.all(np.abs(got[1].numpy()[live] - dref) <= bound), "dmargin"
    v_ref = np.asarray(jtrace.compute_capture_margin(_j(o), _j(d),
                                                     jscene)[1])
    v_got = trace.compute_capture_margin(_t(o), _t(d), tscene)[1].numpy()
    np.testing.assert_array_equal(v_got, v_ref)
    assert v_got.any() and not v_got.all()

    for incl in (0.0, 0.3):
        jdisk = jtypes.Disk.create(6.0, 20.0, inclination=incl)
        tdisk = scene_from_reference(_soft_scene(incl=incl),
                                     device="cpu").disk
        r = np.concatenate([rng.uniform(4.0, 8.0, 200),
                            rng.uniform(18.0, 22.0, 200)])
        ph = rng.uniform(0, 2 * np.pi, 400)
        z = rng.normal(0, 0.3, 400)
        p = np.stack([r * np.cos(ph), r * np.sin(ph) * np.cos(incl),
                      r * np.sin(ph) * np.sin(incl) + z], -1).astype(F32)
        dp = rng.normal(0, 1, p.shape).astype(F32)
        ref = jax.jvp(lambda q: jshading.disk_edge_window(q, jdisk, 0.3),
                      (_j(p),), (_j(dp),))
        got = torch.func.jvp(
            lambda q: shading.disk_edge_window(q, tdisk, 0.3),
            (_t(p),), (_t(dp),))
        _close(got[0], ref[0], 1e-5, 1e-6, f"window {incl}")
        _close(got[1], ref[1], 1e-5, 1e-6, f"dwindow {incl}")
        w = got[0].numpy()
        assert (w > 0.9).any() and (w < 0.1).any()


def _carry_planes(n, seed):
    """Random final-carry planes of a soft trace: every result code, hit
    and tracked positions around the annulus (both sides of the plane),
    tracked heights from grazes to far, unit directions."""
    rng = np.random.default_rng(seed)
    f = F32
    result = rng.integers(0, 4, n).astype(np.int32)  # HORIZON..MAX_DIST
    result[:n // 10] = 4  # MAX_STEPS
    r = rng.uniform(1.8, 80.0, n)
    th = rng.uniform(0.2, np.pi - 0.2, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    y = np.zeros((n, 10))
    y[:, 0] = r
    y[:, 6], y[:, 7] = np.sin(th), np.cos(th)
    y[:, 8], y[:, 9] = np.sin(ph), np.cos(ph)

    def ring(lo, hi, zs):
        rr = rng.uniform(lo, hi, n)
        pp = rng.uniform(0, 2 * np.pi, n)
        return np.stack([rr * np.cos(pp), rr * np.sin(pp),
                         rng.normal(0, zs, n)], -1)

    def unit(k):
        v = rng.normal(0, 1, (k, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    planes = dict(
        y=y, L=rng.normal(0, 4.0, n), dist=rng.uniform(0, 80, n),
        steps=rng.integers(1, 300, n).astype(np.int32), result=result,
        hit_pos=ring(5.0, 21.0, 0.05), last_dir=unit(n),
        min_r=rng.uniform(1.8, 40.0, n),
        min_az=np.where(rng.random(n) < 0.2, 1e9,
                        rng.uniform(0.0, 2.0, n)),
        gpos=ring(5.0, 21.0, 1.0), gdir=unit(n),
    )
    return {k: (v if v.dtype == np.int32 else v.astype(f))
            for k, v in planes.items()}


def test_finalize_soft_matches_jax():
    """finalize of the same carry (with tracking planes) and margin on
    both sides: every Hit field (colour rtol 1e-5, atol 2e-6), and the
    colour's jvp along the mass, min_az, gpos, gdir, min_r and the margin
    (rtol 1e-4, atol 1e-5 of the largest tangent).  Without the tracking
    planes the colour differs: the crossing opacity is live."""
    n = 1024
    P = _carry_planes(n, seed=6)
    o, d = _rays(n, seed=7)
    jscene = _soft_scene()
    tscene = scene_from_reference(jscene, device="cpu")
    m_j, valid_j = jtrace.compute_capture_margin(_j(o), _j(d), jscene)
    m_t, valid_t = trace.compute_capture_margin(_t(o), _t(d), tscene)
    rng = np.random.default_rng(8)
    diff_keys = ("min_az", "gpos", "gdir", "min_r")
    dirs = {k: rng.normal(0, 0.1, P[k].shape).astype(F32) for k in diff_keys}
    dmargin = rng.normal(0, 0.1, n).astype(F32)

    def jfin(mass, margin, *vals, track=True):
        s = _with_mass(jscene, mass)
        kw = {k: _j(v) for k, v in P.items()}
        kw.update(dict(zip(diff_keys, vals)))
        if not track:
            kw.update(min_az=None, gpos=None, gdir=None)
        carry = jtrace.TraceCarry(h=jnp.zeros(n, jnp.float32),
                                  iter=jnp.int32(0), **kw)
        return jtrace.finalize(carry, s, margin=(margin, valid_j))

    def tfin(mass, margin, *vals, track=True):
        s = _with_mass(tscene, mass)
        kw = {k: torch.from_numpy(v) for k, v in P.items()}
        kw.update(dict(zip(diff_keys, vals)))
        if not track:
            kw.update(min_az=None, gpos=None, gdir=None)
        carry = trace.TraceCarry(h=torch.zeros(n), iter=0, **kw)
        return trace.finalize(carry, s, margin=(margin, valid_t))

    one = 1.0
    jargs = (jnp.float32(one), m_j, *(_j(P[k]) for k in diff_keys))
    targs = (torch.tensor(one), m_t, *(_t(P[k]) for k in diff_keys))
    jdirs = (jnp.float32(1.0), _j(dmargin), *(_j(dirs[k]) for k in diff_keys))
    tdirs = (torch.tensor(1.0), _t(dmargin),
             *(_t(dirs[k]) for k in diff_keys))

    hit_ref = jfin(*jargs)
    hit_got = tfin(*targs)
    for name in vars(hit_got):
        g, r = getattr(hit_got, name), np.asarray(getattr(hit_ref, name))
        if name in ("result", "steps"):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        else:
            _close(g, r, 1e-5, 2e-6, name)

    ref = jax.jvp(lambda *a: jfin(*a).color, jargs, jdirs)
    got = torch.func.jvp(lambda *a: tfin(*a).color, targs, tdirs)
    _close(got[0], ref[0], 1e-5, 2e-6, "color")
    dref = np.asarray(ref[1])
    _close(got[1], dref, 1e-4, 1e-5 * np.abs(dref).max(), "dcolor")

    untracked = tfin(*targs, track=False).color
    assert (untracked - hit_got.color).abs().amax(-1).gt(1e-3).sum() > 20
    # valid and the disk mask pick the analytic margin on some rays and
    # min_r on others.
    assert valid_t.any() and not valid_t.all()
