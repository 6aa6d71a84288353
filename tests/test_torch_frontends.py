"""Parity of the port's front ends with the JAX package, on the CPU.

viz.effects (lensing_warp, blackhole_overlay, composite_preview,
particle_overlay), render.adaptive (edge_factor, the top-k selection,
render_adaptive), viz.animate (render_progressive, orbit_camera,
render_orbit_animation with both writers), viz.viewer (ViewerState,
ansi_frame, run) and viz.server (the HTTP surface of
tests/test_server.py), each against the JAX function on the same
inputs (numpy, seeded).  The port runs with device="cpu", on K1's
plain version; the JAX package on the CPU, its "auto" engine taking
XLA there.

Tolerances:
* effects: the port in float64 within 1e-8 of the JAX package (which
  computes in float64 here, 64-bit mode being on; measured <= 7.5e-10),
  in float32 within 5e-6 (float32 rounding of sin/exp arguments up to
  ~30; measured <= 2.2e-6); particle_overlay (float32 on both sides)
  within 1e-6.
* edge_factor (float64) within 1e-12; the adaptive selection equal.
* images: the RK4 contract, colour max < 2e-4 (no result code differs
  in these cases, so every pixel is held).
* orbit_camera within 1e-6.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.particles import generators as jgen
from blackhole_tpu.particles import system as jsys
from blackhole_tpu.render import adaptive as jadaptive
from blackhole_tpu.viz import animate as janimate
from blackhole_tpu.viz import effects as jeffects
from blackhole_tpu.viz import io as jio
from blackhole_tpu.viz import server as jserver
from blackhole_tpu.viz import viewer as jviewer
from blackhole_tpu_torch.geom import types
from blackhole_tpu_torch.particles import system as psys
from blackhole_tpu_torch.render import adaptive, image
from blackhole_tpu_torch.viz import animate, effects, native_io, server
from blackhole_tpu_torch.viz import io as viz_io
from blackhole_tpu_torch.viz import viewer

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py

CPU = dict(device="cpu")
RK4_COLOUR = 2e-4
W, H = 32, 24


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float64)


# --- viz.effects ---------------------------------------------------------


def _effect(name, dtype):
    """(port, JAX) outputs of one effect on seeded inputs."""
    rng = np.random.default_rng(0)
    if name == "lensing_warp":
        img = rng.random((H, W, 3))
        return (effects.lensing_warp(torch.tensor(img, dtype=dtype),
                                     strength=0.25, radius=0.3, dtype=dtype),
                jeffects.lensing_warp(jnp.asarray(img), strength=0.25,
                                      radius=0.3))
    if name.startswith("overlay"):
        disk = name.endswith("disk")
        rgb, alpha = effects.blackhole_overlay(H, W, 0.2, 0.7, disk, 1.3,
                                               dtype=dtype, **CPU)
        jrgb, jalpha = jeffects.blackhole_overlay(H, W, 0.2, 0.7, disk, 1.3)
        return torch.cat([rgb, alpha[..., None]], -1), \
            jnp.concatenate([jrgb, jalpha[..., None]], -1)
    assert name == "composite_preview"
    return (effects.composite_preview(H, W, spin=0.5, time=1.0, seed=3,
                                      dtype=dtype, **CPU),
            jeffects.composite_preview(H, W, spin=0.5, time=1.0, seed=3))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-8),
                                       (torch.float32, 5e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["lensing_warp", "overlay_disk",
                                  "overlay_nodisk", "composite_preview"])
def test_effects_match_jax(name, dtype, tol):
    got, ref = _effect(name, dtype)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol)


def test_particle_overlay_matches_jax():
    """300 particles (some inactive, some behind the camera, some off
    screen, several per pixel: the accumulating splat) on a seeded
    frame, float32 on both sides."""
    rng = np.random.default_rng(1)
    n = 300
    pos = (rng.normal(size=(n, 3)) * 8.0).astype(np.float32)
    pos[:20, 1] = -60.0  # behind the camera
    pos[20:60] = pos[20]  # one pixel, 40 splats
    temps = rng.uniform(0.0, 9000.0, n).astype(np.float32)
    temps[::7] = 0.0  # white
    active = rng.random(n) > 0.1
    img = (rng.random((16, 24, 3)) * 0.5).astype(np.float32)
    jcam = janimate.orbit_camera(30.0, 20.0, 15.0, 40.0)
    cam = animate.orbit_camera(30.0, 20.0, 15.0, 40.0, **CPU)
    got = effects.particle_overlay(torch.tensor(img), torch.tensor(pos),
                                   torch.tensor(temps), torch.tensor(active),
                                   cam)
    ref = jeffects.particle_overlay(jnp.asarray(img), jnp.asarray(pos),
                                    jnp.asarray(temps), jnp.asarray(active),
                                    jcam)
    assert got.dtype == torch.float32
    assert float(np.abs(np.asarray(ref) - img).max()) > 0.1  # splats landed
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


# --- render.adaptive -----------------------------------------------------


def test_edge_factor_matches_jax():
    """A smooth seeded image with a planted step, a line and spikes:
    values below, at and above the threshold, and the border."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([0.3 + 0.01 * xx + 0.005 * yy] * 3, -1)
    img += rng.normal(scale=0.02, size=img.shape)
    img[:, 20:] += 0.5  # a step
    img[10, :] += 0.15  # a line near the threshold
    img[5, 7] = 1.0
    img[15, 12] = 0.0
    got = adaptive.edge_factor(torch.tensor(img), 0.1).numpy()
    ref = np.asarray(jadaptive.edge_factor(jnp.asarray(img), 0.1))
    assert (ref == 1.0).sum() > (ref == 1.0)[2:-2, 2:-2].size // 4
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got == 1.0, ref == 1.0)


def _bench(camera=None):
    """(port, JAX) bench scene (Kerr a=0.9, disk 6-20, 150 steps) and
    camera (0, -35, 12), fov 22; camera: (position, direction, up, fov)
    to look elsewhere."""
    pos, dirn, up, fov = camera or ((0.0, -35.0, 12.0), (0.0, 35.0, -12.0),
                                    (0.0, 0.0, 1.0), 22.0)
    cfg = dict(time_step=0.1, max_ray_distance=150.0, max_steps=150)
    jscene = jtypes.Scene(jtypes.BlackHole.create(1.0, 0.9),
                          jtypes.Disk.create(6.0, 20.0, 1.0, 1.0),
                          jtypes.SimConfig.create(**cfg), True)
    scene = types.Scene(types.BlackHole.create(1.0, 0.9, **CPU),
                        types.Disk.create(6.0, 20.0, 1.0, 1.0, **CPU),
                        types.SimConfig.create(**cfg, **CPU), True)
    cam = dict(position=pos, direction=dirn, up=up, fov_deg=fov)
    return (scene, types.Camera.create(**cam, **CPU),
            jscene, jtypes.Camera.create(**cam))


# The camera of the JAX package's test_adaptive_no_edges_reduces_to_base:
# the hole out of frame, a smooth sky.  Both cases take the defaults
# extra_spp=4, edge_fraction=0.125 (k = 96), so the JAX side compiles
# render_adaptive once.
AWAY = ((0.0, -30.0, 8.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), 20.0)
ADAPTIVE = {"bench": None, "no_edges": AWAY}
K = 96


@pytest.fixture(scope="module")
def adaptive_renders():
    """{case: (port (img, edges) or None, JAX (img, edges))} at 32x24;
    the port renders the bench case only (its plain K1 takes ~5 ms a
    step on the CPU)."""
    out = {}
    for case, camera in ADAPTIVE.items():
        scene, cam, jscene, jcam = _bench(camera)
        got = (adaptive.render_adaptive(scene, cam, W, H)
               if case == "bench" else None)
        ref = jadaptive.render_adaptive(jscene, jcam, W, H)
        out[case] = (got, [np.asarray(r) for r in ref])
    return out


def _jax_top_k(edges, k):
    return np.asarray(jax.lax.top_k(jnp.asarray(edges).reshape(-1), k)[1])


@pytest.mark.parametrize("case", ["bench", "no_edges", "flat"])
def test_adaptive_selection_matches_jax_top_k(adaptive_renders, case):
    """On the same edge map (the JAX render's; for "flat", a constant
    image, where every interior pixel ties at 0 and the border at 1),
    select_pixels picks jax.lax.top_k's pixels in its order."""
    if case == "flat":
        edges = np.asarray(jadaptive.edge_factor(jnp.full((H, W, 3), 0.4)))
        assert set(np.unique(edges[2:-2, 2:-2])) == {0.0}
    else:
        _, (_, edges) = adaptive_renders[case]
    flat = edges.reshape(-1)
    assert (flat == flat[_jax_top_k(edges, K)[-1]]).sum() > K  # ties decide
    got = adaptive.select_pixels(torch.tensor(edges), K).numpy()
    np.testing.assert_array_equal(got, _jax_top_k(edges, K))


def test_render_adaptive_matches_jax(adaptive_renders):
    """The port's whole render_adaptive of the bench case against the
    JAX package's: its own edge map within the RK4 contract's colour
    bound scaled by 1 / edge_threshold, the same selection, the image
    under the RK4 contract."""
    (img, edges), (jimg, jedges) = adaptive_renders["bench"]
    assert img.shape == (H, W, 3) and edges.shape == (H, W)
    np.testing.assert_allclose(edges.numpy(), jedges, rtol=0,
                               atol=RK4_COLOUR / 0.1)
    np.testing.assert_array_equal(adaptive.select_pixels(edges, K).numpy(),
                                  _jax_top_k(jedges, K))
    assert float(np.abs(img.numpy() - jimg).max()) < RK4_COLOUR


# --- viz.animate ---------------------------------------------------------


@pytest.mark.parametrize("angles", [(35.0, 18.0, 0.0, 22.0),
                                    (20.0, -40.0, 137.0, 60.0)])
def test_orbit_camera_matches_jax(angles):
    got = animate.orbit_camera(*angles, **CPU)
    ref = janimate.orbit_camera(*angles)
    for name in ("position", "direction", "up", "fov_deg"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_render_progressive_matches_jax(jax_viewer_run):
    """A two-tier ladder at 32x24 (the viewer's scene at 120 steps; the
    JAX side compiles each tier, so the ladder is cut as in
    tests/test_utils_viz.py, to tiers the JAX viewer run has compiled):
    each tier's divisor, shape and image under the RK4 contract.  The
    default ladder is the JAX package's."""
    assert animate.QUALITY_LADDER == janimate.QUALITY_LADDER
    ladder = ((8, 20), (2, 50))
    state = viewer.ViewerState(steps=120, **CPU)
    jstate = jviewer.ViewerState(steps=120)
    got = list(animate.render_progressive(state.scene(), state.camera(),
                                          W, H, ladder))
    ref = list(janimate.render_progressive(jstate.scene(), jstate.camera(),
                                           W, H, ladder))
    assert [d for d, _ in got] == [d for d, _ in ref] == [8, 2]
    for (_, g), (_, r) in zip(got, ref):
        assert g.shape == r.shape == (H, W, 3)
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) < RK4_COLOUR


def test_orbit_animation_native_and_python_writers_agree(tmp_path):
    """render_orbit_animation through the native writer and through
    viz.io: the decoded frames equal each other and the renders'
    to_uint8."""
    if not native_io.available():
        pytest.skip("native/libframeio.so not built and no toolchain")
    scene = viewer.ViewerState(steps=60, **CPU).scene()
    frames = {}
    for native in (True, False):
        paths = animate.render_orbit_animation(
            scene, str(tmp_path / str(native)), n_frames=3, width=16,
            height=12, use_native_io=native)
        assert [p.rsplit("/", 1)[1] for p in paths] == \
            [f"frame_{k:04d}.png" for k in range(3)]
        frames[native] = [viz_io.read_image(p) for p in paths]
    for a, b in zip(frames[True], frames[False]):
        np.testing.assert_array_equal(a, b)
    cam = animate.orbit_camera(35.0, 18.0, 120.0, 22.0, **CPU)
    img = image.render_image(scene, cam, 16, 12).numpy()
    np.testing.assert_array_equal(
        np.round(frames[True][1] * 255.0).astype(np.uint8),
        viz_io.to_uint8(img))


def test_encode_png_matches_jax_write_png(tmp_path):
    """encode_png's bytes equal the JAX package's write_png file, from a
    float image; a uint8 image is encoded as it is."""
    img = np.random.default_rng(3).random((7, 9, 3)).astype(np.float32)
    jio.write_png(str(tmp_path / "j.png"), img)
    assert viz_io.encode_png(img) == (tmp_path / "j.png").read_bytes()
    assert viz_io.encode_png(viz_io.to_uint8(img)) == viz_io.encode_png(img)


# --- viz.viewer ----------------------------------------------------------

COMMANDS = [
    "", "   ", "help", "save out.png", "disk off", "disk ON", "particles 1",
    "particles off", "sky true", "sky off", "bogus", "mass 2.0", "mass -1",
    "mass abc", "MASS 1.5", "spin 0.9", "spin 1.5", "spin -0.1",
    "charge 0.9", "charge 0.3", "spin 0.5", "charge 0.3", "fov 30",
    "fov 0.5", "fov 121", "dist 50", "dist +10", "dist -100", "dist =-3",
    "dist =40", "el -10", "el =-10", "el 25", "el +5", "az +15", "az -5",
    "az =-30", "az 90", "az x", "steps 300", "steps 10", "steps 20.7",
    "foo 1", "mass 1 2", "disk", "save", "quit", "exit", "q",
]
STATE = ("mass", "spin", "charge", "sky", "fov", "distance", "elevation",
         "azimuth", "steps", "disk", "particles", "n_particles")


def test_viewer_state_apply_matches_jax():
    """Every branch of ViewerState.apply: the same action strings and
    the same state after each command."""
    got, ref = viewer.ViewerState(**CPU), jviewer.ViewerState()
    for line in COMMANDS:
        assert got.apply(line) == ref.apply(line), line
        assert {k: getattr(got, k) for k in STATE} == \
            {k: getattr(ref, k) for k in STATE}, line


def test_viewer_state_records_on_its_device():
    state = viewer.ViewerState(spin=0.9, charge=0.2, sky=True, **CPU)
    scene, cam = state.scene(), state.camera()
    assert scene.env_map.shape == (256, 512, 3)
    np.testing.assert_array_equal(
        scene.env_map.numpy(),
        effects.starfield_envmap(256, 512, seed=7, **CPU).numpy())
    for t in (scene.blackhole.charge, scene.config.time_step, cam.position):
        assert t.device.type == "cpu"
    assert float(scene.blackhole.charge) == pytest.approx(0.2)


@pytest.mark.parametrize("height", [8, 7])
def test_ansi_frame_matches_jax(height):
    img = np.random.default_rng(4).random((height, 5, 3)) * 1.1 - 0.05
    assert viewer.ansi_frame(img) == jviewer.ansi_frame(img)


def _jax_pool(state, n):
    """The JAX viewer's pool: PRNGKey(0) draws on its first scene."""
    scene = state.scene()
    system, _ = jgen.create_accretion_disk(
        jsys.ParticleSystem.create(n), jax.random.PRNGKey(0), n,
        scene.blackhole, scene.disk)
    return system


VIEW_SCRIPT = ["", "", "spin 0.9"] + [""] * 6 + ["save last.png"]
VIEW_KW = dict(steps=120, n_particles=64)
VIEW_RUN = dict(width=W, height=H, max_frames=len(VIEW_SCRIPT),
                commands=VIEW_SCRIPT, draw=False)


@pytest.fixture(scope="module")
def jax_viewer_run():
    """The JAX viewer run once, with particles on (recorded:
    tests/jax_refs.py, case frontends_viewer_run): (stats, its last
    frame as saved, its last frame before the particle overlay).  The
    overlay is the last thing run does to a frame and feeds nothing back
    (history and the ladder take the frame before it), so the run
    without particles has the same tiers and resets, and its last frame
    is the one before the overlay."""
    rec = jax_refs.load("frontends_viewer_run")
    stats = {"frames": int(rec["frames"]), "tiers": rec["tiers"].tolist(),
             "resets": int(rec["resets"])}
    return stats, rec["last"], rec["plain_last"]


@pytest.mark.parametrize("particles", [False, True], ids=["plain",
                                                          "particles"])
def test_viewer_run_matches_jax(jax_viewer_run, particles, monkeypatch):
    """viewer.run headless at 32x24, 120 steps, a script with one
    `spin 0.9` and a save of the last frame: the same tiers and resets
    as the JAX viewer, the last frame (full+2) under the RK4 contract.
    With particles on, the port's pool is the JAX viewer's, carried
    across (particle_system_from_reference)."""
    ref, jax_last, jax_plain_last = jax_viewer_run
    saved = {}
    monkeypatch.setattr(viz_io, "write_image",
                        lambda path, img: saved.setdefault("port", img))
    pools = []

    def seed(n, scene):
        pools.append(n)
        return psys.particle_system_from_reference(
            _jax_pool(jviewer.ViewerState(**VIEW_KW), n), **CPU)

    monkeypatch.setattr(viewer, "seed_particles", seed)
    got = viewer.run(viewer.ViewerState(**VIEW_KW, particles=particles,
                                        **CPU), **VIEW_RUN)
    assert got["frames"] == ref["frames"] == len(VIEW_SCRIPT)
    assert got["tiers"] == ref["tiers"] == [
        "1/32", "1/16", "1/8", "1/32", "1/16", "1/8", "1/4", "1/2",
        "full+1", "full+2"]
    assert got["resets"] == ref["resets"] == 1
    assert pools == ([64] if particles else [])
    diff = np.abs(saved["port"] - (jax_last if particles else jax_plain_last))
    assert float(diff.max()) < RK4_COLOUR


# --- viz.server ----------------------------------------------------------


@pytest.fixture(scope="module")
def running_server():
    """The port's server on the CPU at 32x16, 60 steps, port 0; every
    published frame (float, on the host) and its PNG recorded by seq."""
    published = {}
    publish = server.RenderServer._publish

    def record(self, frame, tier, *args):
        seq = publish(self, frame, tier, *args)
        published[seq] = (frame.numpy().copy(), self._png, tier)
        return seq

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(server.RenderServer, "_publish", record)
        httpd, rt = server.serve(
            host="127.0.0.1", port=0,
            state=viewer.ViewerState(steps=60, **CPU), width=32, height=16,
            block=False,
        )
        rs = httpd.render_server
        try:
            _wait(lambda: rs.frame()[1] >= 1)
            yield httpd, httpd.server_address[1], published
        finally:
            rs.stop()
            rt.join(timeout=60)
            httpd.shutdown()
    assert not rt.is_alive()
    assert rs.error is None, rs.error


def _wait(cond, timeout=120.0):
    import time

    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post(port, line):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/cmd",
                                 data=line.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["action"]


def test_server_page_matches_jax(running_server):
    _, port, _ = running_server
    status, ctype, body = _get(port, "/")
    assert status == 200 and ctype == "text/html; charset=utf-8"
    assert body == jserver._PAGE.encode()


def test_server_frame_png_decodes_to_published_uint8(running_server,
                                                     tmp_path):
    """/frame.png is a published frame's PNG; decoded by viz.io it is
    that frame's uint8 as the JAX server makes it (clip(255 x),
    truncated)."""
    _, port, published = running_server
    status, ctype, body = _get(port, "/frame.png")
    assert status == 200 and ctype == "image/png"
    frame = next(f for f, png, _ in list(published.values()) if png == body)
    u8 = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    (tmp_path / "frame.png").write_bytes(body)
    decoded = np.round(viz_io.read_image(str(tmp_path / "frame.png")) * 255)
    np.testing.assert_array_equal(decoded.astype(np.uint8), u8)


def test_server_state_matches_jax(running_server):
    """/state has the JAX server's keys; shadow_radius and isco are the
    JAX package's at the reported mass and spin within 1e-6."""
    from blackhole_tpu.metrics import derived as jderived

    _, port, _ = running_server
    status, ctype, body = _get(port, "/state")
    s = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert s.keys() == jserver.RenderServer(jviewer.ViewerState()).stats(
    ).keys()
    assert s["seq"] >= 1 and s["status"] != "" and "error" not in s["status"]
    assert s["shadow_radius"] == pytest.approx(
        float(jderived.shadow_radius(s["mass"], s["spin"])), abs=1e-6)
    assert s["isco"] == pytest.approx(
        float(jderived.isco_radius(s["mass"], s["spin"])), abs=1e-6)


def test_server_command_restarts_the_ladder(running_server):
    """A /cmd that changes the state restarts the ladder at 1/32 within
    the frame in flight; a bad command reports an error."""
    httpd, port, published = running_server
    rs = httpd.render_server
    assert _post(port, "el =25") == "changed"
    seq = rs.frame()[1]
    _wait(lambda: any(t == "1/32" for s, (_, _, t) in list(
        published.items()) if s > seq))
    first = min(s for s, (_, _, t) in list(published.items())
                if s > seq and t == "1/32")
    assert first <= seq + 2
    assert json.loads(_get(port, "/state")[2])["elevation"] == 25.0
    assert _post(port, "warp 9").startswith("error")


def test_server_particles_overlay_renders(running_server):
    httpd, port, _ = running_server
    rs = httpd.render_server
    assert _post(port, "particles on") == "changed"
    seq = rs.frame()[1]
    _wait(lambda: rs.frame()[1] > seq + 1)
    assert _post(port, "particles off") == "changed"
    assert rs.error is None


def test_server_unknown_path_404(running_server):
    _, port, _ = running_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404
