"""Image output: PNG (via zlib, dependency-free) and PPM.

This package's own copy of blackhole_tpu.viz.io (numpy and zlib only),
with one addition: encode_png_banded, the served frame's encoder, which
deflates blocks of rows on worker threads (zlib releases the GIL while
it deflates) into the same PNG layout.
Images are numpy arrays: call .cpu().numpy() on a tensor first.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# The served frame's band count (band_count): at most MAX_BANDS bands
# of at least MIN_BAND_ROWS rows, one per usable CPU.  MAX_BANDS is
# where the deflate time of a 1280x720 frame stops falling on an H100
# host's 8 cores (PERF.md, section 6).
MAX_BANDS = 8
MIN_BAND_ROWS = 64
ADLER_BASE = 65521
WINDOW = 32768  # deflate's LZ77 window at zlib's default wbits, 15


def to_uint8(img) -> np.ndarray:
    """Float [0,1] (H, W, 3) -> uint8, gamma-free."""
    arr = np.asarray(img)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_png(img) -> bytes:
    """Minimal RGB8 PNG encoder (zlib only, no PIL): one IDAT, filter 0,
    zlib level 6.  img: (H, W, 3) uint8 as it is, or float [0, 1]
    through to_uint8.  The rows are deflated in one block."""
    return encode_png_banded(img, 1)


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """The Adler-32 of A + B from a1 = adler32(A), a2 = adler32(B) and
    len2 = len(B)."""
    lo = ((a1 & 0xFFFF) + (a2 & 0xFFFF) - 1) % ADLER_BASE
    hi = ((a1 >> 16) + (a2 >> 16) + len2 * ((a1 & 0xFFFF) - 1)) % ADLER_BASE
    return hi << 16 | lo


def _deflate_rows(arr: np.ndarray, y0: int, y1: int):
    """Rows [y0, y1) of arr as filter-0 scanlines, deflated raw at level
    6 and ended by a full flush (a finish for the last rows), so that
    the bands' streams joined in order are one deflate stream.  The
    window starts primed with the (up to) 32 KiB of scanlines before y0,
    which a decoder holds there too: unprimed, 8 bands grow a served
    1280x720 frame's PNG by up to 2.1%; primed, it comes out smaller
    than one band's, for 0.5-0.7 ms more of a 4-7 ms encode on an H100
    host's 8 cores (PERF.md, section 6).  Returns (stream, adler32 of
    the band's scanlines, their length)."""
    stride = 1 + arr.shape[1] * 3
    ys = max(0, y0 - -(-WINDOW // stride))  # the first row the window holds
    rows = np.zeros((y1 - ys, stride), np.uint8)
    rows[:, 1:] = arr[ys:y1].reshape(y1 - ys, -1)
    flat = rows.reshape(-1)
    start = (y0 - ys) * stride
    band = flat[start:]
    c = zlib.compressobj(6, zlib.DEFLATED, -15,
                         zdict=flat[max(0, start - WINDOW):start])
    body = c.compress(band)
    body += c.flush(zlib.Z_FINISH if y1 == len(arr) else zlib.Z_FULL_FLUSH)
    return body, zlib.adler32(band), band.size


def encode_png_banded(img, bands: int, pool=None) -> bytes:
    """encode_png with the rows deflated in `bands` contiguous blocks,
    each on a worker of pool (a concurrent.futures executor, needed for
    more than one band), joined into one stream: the same layout and
    pixels, and a file about the size of one block's."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    h, w, _ = arr.shape
    if not 1 <= bands <= h:
        raise ValueError(f"bands must lie in [1, {h}], got {bands}")
    edges = [h * k // bands for k in range(bands + 1)]
    run = map if bands == 1 else pool.map
    parts = list(run(_deflate_rows, [arr] * bands, edges[:-1], edges[1:]))
    adler = 1
    for _, a, n in parts:
        adler = adler32_combine(adler, a, n)
    zdata = (b"\x78\x9c" + b"".join(p for p, _, _ in parts)
             + struct.pack(">I", adler))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zdata)
        + chunk(b"IEND", b"")
    )


def usable_cpus() -> int:
    """The CPUs this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no sched_getaffinity on this platform
        return os.cpu_count() or 1


def band_count(rows: int) -> int:
    """The bands the server deflates a frame of `rows` rows in: one a
    usable CPU, at most MAX_BANDS, each of at least MIN_BAND_ROWS rows
    (one band for a frame of fewer)."""
    return max(1, min(MAX_BANDS, usable_cpus(), rows // MIN_BAND_ROWS))


def write_png(path: str, img) -> None:
    """Write img as an RGB8 PNG (encode_png)."""
    png = encode_png(img)
    with open(path, "wb") as f:
        f.write(png)


def write_ppm(path: str, img) -> None:
    """Binary PPM (P6)."""
    arr = to_uint8(img)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def write_image(path: str, img) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, img)
    else:
        write_png(path, img)


def read_image(path: str) -> np.ndarray:
    """Read an RGB image back as float32 [0,1] (H, W, 3).  Uses PIL when
    available, else decodes our own PNG/PPM output formats."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return (
                np.asarray(im.convert("RGB"), np.float32) / 255.0
            )
    except ImportError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        header, rest = data.split(b"\n", 3)[0:3], data
        parts = data.split(b"\n", 3)
        w, h = map(int, parts[1].split())
        arr = np.frombuffer(parts[3], np.uint8, count=w * h * 3)
        return arr.reshape(h, w, 3).astype(np.float32) / 255.0
    # Our minimal PNG layout: IHDR, one IDAT, IEND.
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "unsupported image"
    w, h = struct.unpack(">II", data[16:24])
    idat_start = data.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", data[idat_start - 8:idat_start - 4])[0]
    raw = zlib.decompress(data[idat_start:idat_start + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * 3)
    assert np.all(rows[:, 0] == 0), "only filter-0 PNGs supported"
    return rows[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0
