"""Parity of the port's physics leftovers with the JAX package.

geom.coords (the spherical maps, their direction maps, Boyer-Lindquist
to cartesian), geom.types (BlackHole's schwarzschild_radius, r_minus,
ergosphere_radius; Hit indexing), metrics.kerr's matrices,
metrics.schwarzschild, metrics.christoffel, the rest of metrics.derived,
render.camera.generate_rays_for_pixels, render.shading's
doppler_shift_wavelength and apply_redshift_to_rgb, and viz.effects'
starfield.  One parametrised test per module; the inputs are seeded
float32 (r, theta) and position batches given to both packages.

Tolerances: the float32 closed forms within rtol 1e-6, atol 1e-6 (the
libraries' transcendentals round differently by an ulp or two);
christoffel, which differentiates the metric by jacfwd, within rtol
1e-5.  The starfield's hash and star field are equal bit for bit at
64x128; the environment map is equal bit for bit everywhere except on
the rows whose equator band exp(x) XLA and torch round differently in
float32 (found by the test itself), which differ by at most one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import coords as jcoords
from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.metrics import christoffel as jchris
from blackhole_tpu.metrics import derived as jderived
from blackhole_tpu.metrics import kerr as jkerr
from blackhole_tpu.metrics import schwarzschild as jschw
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import shading as jshading
from blackhole_tpu.viz import effects as jeffects
from blackhole_tpu_torch.geom import coords, types
from blackhole_tpu_torch.metrics import christoffel, derived, kerr
from blackhole_tpu_torch.metrics import schwarzschild
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import shading
from blackhole_tpu_torch.viz import effects

torch.set_num_threads(1)  # see tests/test_torch_step.py

F32 = np.float32
RTOL, ATOL = 1e-6, 1e-6
N = 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "r": rng.uniform(2.5, 30.0, N).astype(F32),
        "theta": rng.uniform(0.1, np.pi - 0.1, N).astype(F32),
        "phi": rng.uniform(0.0, 2 * np.pi, N).astype(F32),
        "xyz": (rng.normal(size=(N, 3)) * 10.0).astype(F32),
        "dxyz": rng.normal(size=(N, 3)).astype(F32),
        "M": rng.uniform(0.5, 2.0, N).astype(F32),
        "spin": rng.uniform(0.0, 0.99, N).astype(F32),
        "charge": rng.uniform(0.0, 0.1, N).astype(F32),
        "l": rng.uniform(-6.0, 6.0, N).astype(F32),
        "rgb": rng.uniform(0.0, 1.0, (N, 3)).astype(F32),
        "z": rng.uniform(-0.5, 2.0, N).astype(F32),
        "beta": rng.uniform(-0.99, 0.99, N).astype(F32),
    }


def _close(got, ref, rtol=RTOL, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, rtol, atol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _sph(v):
    return np.stack([v["r"], v["theta"], v["phi"]], -1)


COORDS = {
    "cartesian_to_spherical": lambda m, v: m.cartesian_to_spherical(
        _both(v["xyz"])[m is coords]),
    "spherical_to_cartesian": lambda m, v: m.spherical_to_cartesian(
        _both(_sph(v))[m is coords]),
    "spherical_direction_from_cartesian":
        lambda m, v: m.spherical_direction_from_cartesian(
            _both(_sph(v))[m is coords], _both(v["dxyz"])[m is coords]),
    "cartesian_direction_from_spherical":
        lambda m, v: m.cartesian_direction_from_spherical(
            _both(_sph(v))[m is coords], _both(v["dxyz"])[m is coords]),
    "boyer_lindquist_to_cartesian":
        lambda m, v: m.boyer_lindquist_to_cartesian(
            _both(_sph(v))[m is coords], _both(v["spin"])[m is coords]),
}


@pytest.mark.parametrize("name", sorted(COORDS))
def test_coords_match_jax(name):
    v = _inputs(1)
    # The poles' guard: dphi is 0 where sin(theta) vanishes.
    v["theta"][:2] = (0.0, np.pi)
    _close(COORDS[name](coords, v), COORDS[name](jcoords, v))


@pytest.mark.parametrize("prop", ["schwarzschild_radius", "r_plus",
                                  "r_minus", "ergosphere_radius"])
def test_blackhole_properties_match_jax(prop):
    for mass, spin, charge in ((1.0, 0.0, 0.0), (1.3, 0.9, 0.0),
                               (0.7, 0.0, 0.3), (2.0, 0.5, 0.4)):
        ref = getattr(jtypes.BlackHole.create(mass, spin, charge), prop)
        got = getattr(types.BlackHole.create(mass, spin, charge,
                                             device="cpu"), prop)
        assert got.dtype == torch.float32
        _close(got, ref)


def test_hit_getitem_indexes_every_field():
    v = _inputs(2)
    fields = [f.name for f in types.dataclasses.fields(types.Hit)]
    hit = types.Hit(*(torch.from_numpy(v["xyz"]) + i
                      for i in range(len(fields))))
    for idx in (3, slice(2, 5), torch.tensor([0, 7, 7])):
        sub = hit[idx]
        for name in fields:
            assert torch.equal(getattr(sub, name), getattr(hit, name)[idx])


KERR = {
    "metric_matrix": lambda m, v, b: m.metric_matrix(
        b(v["r"]), b(v["theta"]), b(v["M"]), b(v["spin"] * v["M"]),
        b(v["charge"])),
    "inverse_metric_matrix": lambda m, v, b: m.inverse_metric_matrix(
        b(v["r"] + 2.0), b(v["theta"]), b(v["M"]), b(v["spin"] * v["M"]),
        b(v["charge"])),
}


@pytest.mark.parametrize("name", sorted(KERR))
def test_kerr_matrices_match_jax(name):
    v = _inputs(3)
    got = KERR[name](kerr, v, torch.from_numpy)
    assert got.shape == (N, 4, 4)
    _close(got, KERR[name](jkerr, v, jnp.asarray))


SCHW = {
    "metric": lambda m, v, b: m.metric(b(v["r"]), b(v["theta"]), b(v["M"])),
    "metric_equatorial": lambda m, v, b: m.metric_equatorial(
        b(v["r"]), b(v["M"])),
}


@pytest.mark.parametrize("name", sorted(SCHW))
def test_schwarzschild_matches_jax(name):
    v = _inputs(4)
    v["r"] = v["r"] + 2.0 * v["M"] + 0.5
    _close(tuple(SCHW[name](schwarzschild, v, torch.from_numpy)),
           tuple(SCHW[name](jschw, v, jnp.asarray)))


def _jax_christoffel(r, th, M, a, Q):
    return jax.vmap(lambda rr, tt: jchris.christoffel(rr, tt, M, a, Q))(
        jnp.asarray(r), jnp.asarray(th))


@pytest.mark.parametrize("case", ["kerr_newman", "schwarzschild_oracle",
                                  "geodesic_acceleration"])
def test_christoffel_matches_jax(case):
    v = _inputs(5)
    r, th = v["r"] + 2.0, v["theta"]
    M, a, Q = F32(1.2), F32(0.8), F32(0.2)
    t = torch.from_numpy
    Mt, at, Qt = (torch.tensor(x) for x in (M, a, Q))
    if case == "kerr_newman":
        got = christoffel.christoffel(t(r), t(th), Mt, at, Qt)
        assert got.shape == (N, 4, 4, 4)
        _close(got, _jax_christoffel(r, th, M, a, Q), rtol=1e-5)
        one = christoffel.christoffel(torch.tensor(r[0]),
                                      torch.tensor(th[0]), Mt, at, Qt)
        _close(one, jchris.christoffel(r[0], th[0], M, a, Q), rtol=1e-5)
    elif case == "schwarzschild_oracle":
        got = christoffel.schwarzschild_christoffel_analytic(t(r), t(th), Mt)
        ref = jax.vmap(lambda rr, tt: jchris.schwarzschild_christoffel_analytic(
            rr, tt, M))(jnp.asarray(r), jnp.asarray(th))
        _close(got, ref)
        # The autodiff symbols reproduce the oracle at a = Q = 0.
        _close(christoffel.christoffel(t(r), t(th), Mt, 0.0, 0.0), ref,
               rtol=1e-5)
    else:
        pos = np.stack([np.zeros_like(r), r, th, v["phi"]], -1)
        vel = np.concatenate([np.ones((N, 1), F32), v["dxyz"] * 0.1], -1)
        got = christoffel.geodesic_acceleration(t(pos), t(vel), Mt, at, Qt)
        ref = jax.vmap(lambda p, u: jchris.geodesic_acceleration(
            p, u, M, a, Q))(jnp.asarray(pos), jnp.asarray(vel))
        _close(got, ref, rtol=1e-5)


DERIVED = {
    "isco_radius": lambda m, v, b: m.isco_radius(b(v["M"]), b(v["spin"])),
    "isco_radius_retrograde": lambda m, v, b: m.isco_radius(
        b(v["M"]), b(v["spin"]), prograde=False),
    "inner_horizon": lambda m, v, b: m.inner_horizon(
        b(v["M"]), b(v["spin"]), b(v["charge"])),
    "ergosphere_radius": lambda m, v, b: m.ergosphere_radius(
        b(v["theta"]), b(v["M"]), b(v["spin"])),
    "frame_dragging_omega": lambda m, v, b: m.frame_dragging_omega(
        b(v["r"]), b(v["theta"]), b(v["M"]), b(v["spin"])),
    "effective_potential_schwarzschild": lambda m, v, b:
        m.effective_potential(b(v["r"]), b(v["l"]), b(v["M"]), 0.0),
    "effective_potential_kerr": lambda m, v, b: m.effective_potential(
        b(v["r"]), b(v["l"]), b(v["M"]), b(v["spin"] + 0.005)),
    "photon_sphere_radius": lambda m, v, b: m.photon_sphere_radius(
        b(v["M"]), b(v["charge"] * v["M"] * 5.0)),
    "rn_critical_impact_parameter": lambda m, v, b:
        m.rn_critical_impact_parameter(b(v["M"]),
                                       b(v["charge"] * v["M"] * 5.0)),
    "shadow_radius": lambda m, v, b: [
        m.shadow_radius(b(v["M"][i:i + 1]), float(v["spin"][i]))
        for i in range(8)],
    "shadow_radius_schwarzschild": lambda m, v, b: m.shadow_radius(
        b(v["M"])),
    "hawking_temperature": lambda m, v, b: m.hawking_temperature(b(v["M"])),
}


@pytest.mark.parametrize("name", sorted(DERIVED))
def test_derived_match_jax(name):
    v = _inputs(6)
    _close(DERIVED[name](derived, v, torch.from_numpy),
           DERIVED[name](jderived, v, jnp.asarray))


RENDER = {
    "generate_rays_for_pixels": lambda m, v, b: m.generate_rays_for_pixels(
        v["camera"], 48, 32, b(v["px"]), b(v["py"]), b(v["ox"]),
        b(v["oy"])),
    "doppler_shift_wavelength": lambda m, v, b: m.doppler_shift_wavelength(
        b(v["r"] * 20.0), b(v["beta"])),
    "apply_redshift_to_rgb": lambda m, v, b: m.apply_redshift_to_rgb(
        b(v["rgb"]), b(v["z"])),
}


@pytest.mark.parametrize("name", sorted(RENDER))
def test_render_leftovers_match_jax(name):
    v = _inputs(7)
    rng = np.random.default_rng(7)
    v["px"] = rng.integers(0, 48, N).astype(np.int32)
    v["py"] = rng.integers(0, 32, N).astype(np.int32)
    v["ox"], v["oy"] = rng.uniform(0, 1, (2, N)).astype(F32)
    camera = dict(position=(0.0, -30.0, 8.0), direction=(0.0, 30.0, -8.0),
                  up=(0.0, 0.0, 1.0), fov_deg=25.0)
    mod = {"generate_rays_for_pixels": (cam, jcam)}.get(
        name, (shading, jshading))
    got = RENDER[name](mod[0], {**v, "camera": types.Camera.create(
        **camera, device="cpu")}, torch.from_numpy)
    ref = RENDER[name](mod[1], {**v, "camera": jtypes.Camera.create(
        **camera)}, jnp.asarray)
    _close(got, ref)


@pytest.mark.parametrize("what", ["hash01", "starfield", "starfield_envmap"])
def test_starfield_matches_jax_bitwise(what):
    h, w = 64, 128
    with jax.enable_x64(False):  # the JAX package's own float32 arithmetic
        iy = jax.lax.broadcasted_iota(jnp.uint32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.uint32, (h, w), 1)
        tix, tiy = effects._indices(h, w, "cpu")
        for seed in (0, 7):
            if what == "hash01":
                ref = np.asarray(jeffects._hash01(ix, iy, seed))
                got = effects._hash01(tix, tiy, seed).numpy()
            else:
                ref = np.asarray(getattr(jeffects, what)(h, w, seed=seed))
                got = getattr(effects, what)(h, w, seed=seed,
                                             device="cpu").numpy()
            assert got.dtype == ref.dtype == np.float32
            assert got.shape == ref.shape
            rows = np.zeros(h, bool)
            if what == "starfield_envmap":
                v = (np.arange(h, dtype=F32) + 0.5) / h
                arg = -(((v - F32(0.5)) / F32(0.08)) ** 2)
                rows = (np.asarray(jnp.exp(jnp.asarray(arg)))
                        != torch.exp(torch.from_numpy(arg)).numpy())
                assert rows.sum() < h // 4
                np.testing.assert_array_max_ulp(got[rows], ref[rows], 1)
            np.testing.assert_array_equal(got[~rows], ref[~rows])
        xs, ys = effects._grid(h, w, "cpu")
        jx, jy = jeffects._grid(h, w)
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
