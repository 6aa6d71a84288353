"""Module parity of the PyTorch port against the JAX package.

Each case makes its inputs from a numpy seed, hands the same float32
arrays to the JAX function and to its counterpart in blackhole_tpu_torch,
and compares.  Both sides compute in float32 with the same operations;
they differ where the libraries' transcendentals (sin, cos, arccos,
atan2, pow, sqrt) round differently, a few ulp, so the default tolerance
is rtol 1e-5 with an absolute floor of 1e-6 at unit scale.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import coords as jcoords
from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.metrics import derived as jderived
from blackhole_tpu.metrics import kerr as jkerr
from blackhole_tpu.render import camera as jcam
from blackhole_tpu.render import geodesic as jgeo
from blackhole_tpu.render import shading as jshading
from blackhole_tpu_torch.geom import coords, types
from blackhole_tpu_torch.metrics import derived, kerr
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import geodesic, shading

ROOT = Path(__file__).resolve().parent.parent
F32 = np.float32


def _close(got, ref, rtol=1e-5, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref.astype(got.dtype), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.from_numpy(np.asarray(x, F32))


def test_coords_match_jax():
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 20, (2000, 3)).astype(F32)
    xyz[:5] = [[0, 0, 7], [3, 0, 0], [0, -2, 0], [1e-4, 0, 5], [0, 0, 0]]
    for a in (0.0, 0.9):
        _close(coords.cartesian_to_boyer_lindquist(_t(xyz), a),
               jcoords.cartesian_to_boyer_lindquist(jnp.asarray(xyz), a),
               atol=2e-6)
    v = rng.normal(0, 3, (500, 3)).astype(F32)
    v[0] = 0.0
    _close(coords.normalize(_t(v)), jcoords.normalize(jnp.asarray(v)))


def test_kerr_metric_and_derived_match_jax():
    rng = np.random.default_rng(1)
    r = rng.uniform(1.5, 100.0, 1000).astype(F32)
    th = rng.uniform(0.05, np.pi - 0.05, 1000).astype(F32)
    M, a, Q = F32(1.0), F32(0.9), F32(0.3)
    tM, ta, tQ = _t(M), _t(a), _t(Q)
    for g, gj in zip(kerr.metric(_t(r), _t(th), tM, ta, tQ),
                     jkerr.metric(r, th, M, a, Q)):
        _close(g, gj, atol=1e-5)
    for g, gj in zip(kerr.sigma_delta(_t(r), _t(th), tM, ta, tQ),
                     jkerr.sigma_delta(r, th, M, a, Q)):
        _close(g, gj)
    _close(derived.time_dilation(_t(r), tM), jderived.time_dilation(r, M))
    _close(derived.keplerian_orbital_velocity(_t(r), tM),
           jderived.keplerian_orbital_velocity(r, M))
    _close(derived.static_time_dilation_kerr(_t(r), tM, ta, tQ),
           jderived.static_time_dilation_kerr(r, M, a, Q))
    spins = rng.uniform(-0.99, 0.99, 64).astype(F32)
    for sign in (1.0, -1.0):
        _close(derived.kerr_circular_omega(_t(r), tM, ta, sign),
               jderived.kerr_circular_omega(r, M, a, sign))
        _close(derived.kerr_photon_orbit_radius(tM, _t(spins), sign),
               jderived.kerr_photon_orbit_radius(M, spins, sign))


def test_camera_matches_jax():
    jcamera = jtypes.Camera.create(position=(2.0, -30.0, 8.0),
                                   direction=(-2.0, 30.0, -8.0),
                                   up=(0.0, 0.0, 1.0), fov_deg=31.0)
    camera = types.camera_from_reference(jcamera)
    for f, fj in zip(cam.camera_basis(camera), jcam.camera_basis(jcamera)):
        _close(f, fj)
    idx = np.arange(0, 5000, 7, dtype=np.int32)
    for base in (2, 3):
        # XLA contracts the digit sum's multiply-add into an FMA: 1 ulp.
        _close(cam.halton(torch.from_numpy(idx), base), jcam.halton(idx, base),
               rtol=0, atol=1.2e-7)
    for method, spp in (("halton", 4), ("grid", 4), ("none", 4),
                        ("halton", 1)):
        for s in range(spp):
            got = cam.jitter_offsets(s, spp, method=method)
            ref = jcam.jitter_offsets(jnp.int32(s), spp, method=method)
            for g, r in zip(got, ref):
                _close(g.reshape(()), np.asarray(r, F32).reshape(()))
    ox, oy = jcam.jitter_offsets(jnp.int32(3), 4)
    o, d = cam.generate_rays(camera, 24, 16, _t(ox), _t(oy))
    oj, dj = jcam.generate_rays(jcamera, 24, 16, ox, oy)
    _close(o, oj, rtol=0, atol=0)
    _close(d, dj)


@pytest.mark.parametrize("spin,charge", [(0.0, 0.0), (0.9, 0.0), (0.6, 0.5)])
def test_init_null_rays_aug_matches_jax(spin, charge):
    jcamera = jtypes.Camera.create(position=(0.0, -30.0, 8.0),
                                   direction=(0.0, 30.0, -8.0),
                                   up=(0.0, 0.0, 1.0), fov_deg=25.0)
    o, d = jcam.generate_rays(jcamera, 32, 32)
    o = np.array(o, F32).reshape(-1, 3)
    d = np.array(jcoords.normalize(d), F32).reshape(-1, 3)
    o[:4] = [[0, 0, 40], [0, 0, -25], [1e-5, 0, 30], [5, 5, 5]]  # on-axis
    M, a, Q = F32(1.0), F32(spin), F32(charge)
    got = geodesic.init_null_rays_aug(_t(o), _t(d), _t(M), _t(a), _t(Q))
    ref = jgeo.init_null_rays_aug(jnp.asarray(o), jnp.asarray(d), M, a, Q)
    y, yj = got[0].numpy(), np.asarray(ref[0])
    assert y.shape == (1024, geodesic.NAUG) and y.dtype == F32
    # The BL velocity is a forward-mode derivative (torch.func.jvp against
    # jax.jvp): the momenta carry the derivative's rounding, a few ulp of
    # magnitudes up to ~30.
    _close(y[:, :3], yj[:, :3])
    _close(y[:, 3:5], yj[:, 3:5], rtol=1e-4, atol=1e-4)
    _close(y[:, 5:], yj[:, 5:], atol=2e-6)
    _close(got[1], ref[1], rtol=0, atol=0)
    _close(got[2], ref[2], rtol=1e-4, atol=1e-4)
    _close(got[3], ref[3], rtol=1e-4, atol=1e-3)
    _close(geodesic.carter_constant(got[0], got[1], got[2], _t(a)),
           jgeo.carter_constant(ref[0], ref[1], ref[2], a),
           rtol=1e-4, atol=1e-3)


def _disk_hits(rng, n, incl):
    """Points in the annulus of a disk inclined by incl about x, and
    photon directions."""
    rad = rng.uniform(5.0, 21.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    x, yp = rad * np.cos(ang), rad * np.sin(ang)
    pos = np.stack([x, yp * np.cos(incl), yp * np.sin(incl)], -1)
    dirs = rng.normal(0, 1, (n, 3))
    return pos.astype(F32), dirs.astype(F32)


@pytest.mark.parametrize("mode", ["auto", "compat", "kerr"])
@pytest.mark.parametrize("incl", [0.0, 0.35], ids=["equatorial", "inclined"])
def test_shade_disk_hit_matches_jax(mode, incl):
    rng = np.random.default_rng(7)
    pos, dirs = _disk_hits(rng, 600, incl)
    L = rng.normal(0, 4.0, 600).astype(F32)
    jbh = jtypes.BlackHole.create(1.0, 0.9, 0.1)
    jdisk = jtypes.Disk.create(6.0, 20.0, 1.3, 1.0, inclination=incl)
    jcfg = jtypes.SimConfig.create(disk_kinematics=mode)
    jscene = jtypes.Scene(jbh, jdisk, jcfg)
    scene = types.scene_from_reference(jscene)
    got = shading.shade_disk_hit(_t(pos), _t(dirs), scene.blackhole,
                                 scene.disk, scene.config, L=_t(L))
    ref = jshading.shade_disk_hit(jnp.asarray(pos), jnp.asarray(dirs), jbh,
                                  jdisk, jcfg, L=jnp.asarray(L))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-4, atol=1e-5)
    # Without L the exact kinematics are unavailable: compat everywhere.
    got = shading.shade_disk_hit(_t(pos), _t(dirs), scene.blackhole,
                                 scene.disk, scene.config)
    ref = jshading.shade_disk_hit(jnp.asarray(pos), jnp.asarray(dirs), jbh,
                                  jdisk, jcfg)
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-4, atol=1e-5)


def test_shading_helpers_match_jax():
    rng = np.random.default_rng(11)
    temp = rng.uniform(0, 5e4, 400).astype(F32)
    _close(shading.temperature_to_rgb(_t(temp)),
           jshading.temperature_to_rgb(temp))
    dirs = rng.normal(0, 1, (400, 3)).astype(F32)
    _close(shading.sky_color(_t(dirs)), jshading.sky_color(dirs))
    env = rng.uniform(0, 1, (16, 32, 3)).astype(F32)
    _close(shading.sample_environment(_t(dirs), _t(env)),
           jshading.sample_environment(dirs, env), atol=1e-5)
    color = rng.uniform(0, 1, (400, 3)).astype(F32)
    dop = rng.uniform(0.3, 2.0, 400).astype(F32)
    grav = rng.uniform(0.8, 3.0, 400).astype(F32)
    for flags in ((True, True, True), (False, True, False),
                  (True, False, True)):
        _close(shading.apply_relativistic_effects(_t(color), _t(dop),
                                                  _t(grav), *flags),
               jshading.apply_relativistic_effects(color, dop, grav, *flags))


def test_kerr_mode_warns_for_inclined_disk(caplog):
    pos, dirs = _disk_hits(np.random.default_rng(2), 8, 0.4)
    scene = types.scene_from_reference(jtypes.Scene(
        jtypes.BlackHole.create(1.0, 0.5),
        jtypes.Disk.create(inclination=0.4),
        jtypes.SimConfig.create(disk_kinematics="kerr"),
    ))
    with caplog.at_level("WARNING"):
        shading.shade_disk_hit(_t(pos), _t(dirs), scene.blackhole,
                               scene.disk, scene.config, L=torch.ones(8))
    assert "falling back to the compat" in caplog.text


def test_scene_from_reference_round_trips():
    env = np.random.default_rng(3).uniform(0, 1, (4, 8, 3)).astype(F32)
    jscene = jtypes.Scene(
        jtypes.BlackHole.create(1.5, 0.7, 0.2),
        jtypes.Disk.create(5.0, 18.0, 1.2, 0.8, 0.04, 0.2, 0.3),
        jtypes.SimConfig.create(
            time_step=0.2, max_ray_distance=90.0, tolerance=1e-5,
            max_steps=321, integrator="rkf45", enable_doppler=False,
            enable_redshift=False, enable_beaming=False, show_disk=False,
            shadow_softness=0.25, disk_kinematics="compat",
        ),
        disk_enabled=False,
        env_map=jnp.asarray(env),
    )
    scene = types.scene_from_reference(jscene)
    for part in ("blackhole", "disk", "config"):
        for name, value in vars(getattr(scene, part)).items():
            ref = getattr(getattr(jscene, part), name)
            if isinstance(value, torch.Tensor):
                assert value.dtype == torch.float32
                np.testing.assert_array_equal(value.numpy(), np.asarray(ref))
            else:
                assert value == ref, name
    assert scene.disk_enabled is False
    np.testing.assert_array_equal(scene.env_map.numpy(), env)
    _close(scene.blackhole.a, jscene.blackhole.a, rtol=0, atol=0)
    _close(scene.blackhole.r_plus, jscene.blackhole.r_plus, atol=0)
    jcamera = jtypes.Camera.create((1.0, 2.0, 3.0), (0.0, -1.0, 0.5),
                                   (0.0, 0.0, 1.0), 33.0)
    camera = types.camera_from_reference(jcamera)
    for name, value in vars(camera).items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(jcamera, name)))
    with pytest.raises(ValueError):
        types.SimConfig.create(disk_kinematics="bogus")


def test_port_never_imports_jax():
    """Importing the port and rendering 8x8 leaves jax out of sys.modules,
    and no module of the package names jax in an import."""
    code = (
        "import sys\n"
        "from blackhole_tpu_torch.geom.types import "
        "BlackHole, Camera, Disk, Scene, SimConfig\n"
        "from blackhole_tpu_torch.render import image\n"
        "scene = Scene(BlackHole.create(1.0, 0.9), Disk.create(),\n"
        "              SimConfig.create(max_steps=40))\n"
        "img = image.render_image(scene, Camera.create(), 8, 8)\n"
        "assert img.shape == (8, 8, 3)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    for path in (ROOT / "blackhole_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and any(w.startswith("jax") for w in words[1:2])), \
                f"{path}: {line}"
