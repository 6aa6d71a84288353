"""Image output: PNG (via zlib, dependency-free) and PPM.

This package's own copy of blackhole_tpu.viz.io (numpy and zlib only).
Images are numpy arrays: call .cpu().numpy() on a tensor first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """Float [0,1] (H, W, 3) -> uint8, gamma-free."""
    arr = np.asarray(img)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_png(img) -> bytes:
    """Minimal RGB8 PNG encoder (zlib only, no PIL): one IDAT, filter 0,
    zlib level 6.  img: (H, W, 3) uint8 as it is, or float [0, 1]
    through to_uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    h, w, _ = arr.shape
    raw = b"".join(
        b"\x00" + arr[y].tobytes() for y in range(h)
    )

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
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


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
