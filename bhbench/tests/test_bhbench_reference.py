"""The plain reference against the program's CPU path at tiny sizes, and
the PNG decoder."""

import struct
import zlib

import numpy as np
import pytest
import torch

from bhbench import scenes
from bhbench.reference import geodesic as G
from bhbench.reference import png
from bhbench.tests import tiny

torch.set_num_threads(1)


def _config():
    import json

    cfg = json.loads((tiny.DATA / "tiny_bench.json").read_text())
    cfg.update(width=12, height=10)
    cfg["sim"].update(time_step=0.1, max_steps=250)
    return cfg


def test_reference_colours_match_the_program_on_the_cpu():
    from blackhole_tpu_torch.render import image

    cfg = _config()
    scene = scenes.port_scene(cfg, "cpu")
    for az in (0.0, 131.0):
        pos = scenes.orbit(cfg["camera"], az)
        cam = scenes.port_camera(cfg["camera"], "cpu", pos)
        got = image.render_image(scene, cam, cfg["width"], cfg["height"])
        o, d = G.image_rays(scenes.ref_camera(cfg["camera"], pos),
                            cfg["width"], cfg["height"])
        ref, steps, result = G.colours(o, d, scenes.ref_scene(cfg))
        assert torch.allclose(got.reshape(-1, 3), ref, atol=1e-6, rtol=0)
        assert int(steps.min()) > 0 and (result == G.DISK).any()


def test_reference_gradient_matches_the_program_on_the_cpu():
    from blackhole_tpu_torch.grad import fast_grad
    from blackhole_tpu_torch.render import camera as cam_mod

    cfg = _config()
    scene = scenes.port_scene(cfg, "cpu")
    cam = scenes.port_camera(cfg["camera"], "cpu")
    o, d = cam_mod.generate_rays(cam, cfg["width"], cfg["height"])
    vg = fast_grad.scene_value_and_grad(
        lambda hit: hit.color.sum() / hit.color.numel(),
        lambda p: scenes.with_mass_spin(scene, p["mass"], p["spin"]))
    loss, g = vg({"mass": torch.tensor(1.02), "spin": torch.tensor(0.88)},
                 o.reshape(-1, 3), d.reshape(-1, 3))
    ro, rd = G.image_rays(cfg["camera"], cfg["width"], cfg["height"])
    rl, (gm, gs), _ = G.loss_and_grad(
        ro, rd, lambda m, s: scenes.ref_scene(cfg, m, s), 1.02, 0.88)
    assert rl == pytest.approx(float(loss), rel=1e-6)
    assert gm == pytest.approx(float(g["mass"]), rel=1e-4, abs=1e-7)
    assert gs == pytest.approx(float(g["spin"]), rel=1e-4, abs=1e-7)


def test_reference_in_bfloat16_is_far_from_float32():
    cfg = _config()
    o, d = G.image_rays(cfg["camera"], cfg["width"], cfg["height"])
    ref, _, _ = G.colours(o, d, scenes.ref_scene(cfg))
    lo, _, _ = G.colours(o.bfloat16(), d.bfloat16(), scenes.ref_scene(cfg))
    assert float(torch.nan_to_num((lo.float() - ref).abs(), 10.0).mean()) \
        > 1e-2


def _png(img, filt):
    """An RGB8 PNG of img whose every row is stored under filter filt."""
    h, w, _ = img.shape
    a = img.astype(np.int32)
    rows = []
    for y in range(h):
        cur = a[y].reshape(-1)
        up = a[y - 1].reshape(-1) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        if filt == 0:
            pred = 0
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = up
        elif filt == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([filt]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = zlib.compress(b"".join(rows))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                       2, 0, 0, 0))
            + chunk(b"IDAT", raw[:7]) + chunk(b"IDAT", raw[7:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_decoder_reads_every_filter(filt):
    img = np.random.default_rng(filt).integers(0, 256, (5, 7, 3), np.uint8)
    assert np.array_equal(png.decode_rgb8(_png(img, filt)), img)


def test_png_decoder_reads_the_servers_encoder():
    from blackhole_tpu_torch.viz import io as viz_io

    img = np.random.default_rng(1).integers(0, 256, (9, 16, 3), np.uint8)
    assert np.array_equal(png.decode_rgb8(viz_io.encode_png(img)), img)
    bad = bytearray(viz_io.encode_png(img))
    bad[40] ^= 1
    with pytest.raises(ValueError):
        png.decode_rgb8(bytes(bad))
