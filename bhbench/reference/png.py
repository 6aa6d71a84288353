"""A plain PNG decoder for 8-bit RGB images (zlib and numpy only).

It reads back what the render server published: IHDR, every IDAT in
order, and each scanline under any of the five standard filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth_row(raw, prior, bpp):
    out = raw.astype(np.int32)
    pr = prior.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = pr[i]
        c = pr[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def decode_rgb8(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG; raises
    ValueError on anything else."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"not 8-bit RGB non-interlaced: {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 3 * w
    if raw.size != h * (stride + 1):
        raise ValueError("IDAT size does not match the header")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:  # Sub: running sum per channel
            cur = (np.cumsum(line.reshape(w, 3).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = (line.astype(np.int32) + prior) .astype(np.uint8)
        elif f == 3:  # Average: sequential along the row
            cur = line.astype(np.int32)
            for i in range(stride):
                left = cur[i - 3] if i >= 3 else 0
                cur[i] = (cur[i] + ((left + int(prior[i])) >> 1)) & 0xFF
            cur = cur.astype(np.uint8)
        elif f == 4:
            cur = _paeth_row(line, prior, 3)
        else:
            raise ValueError(f"unknown filter {f}")
        out[y] = cur
        prior = cur
    return out.reshape(h, w, 3)
