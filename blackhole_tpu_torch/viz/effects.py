"""Procedural starfield for the renderer's sky.

PyTorch counterpart of the starfield part of blackhole_tpu.viz.effects:
_grid, _hash01, starfield and starfield_envmap.  The JAX hash
multiplies in wrapping uint32; torch's uint32 has few arithmetic ops,
so the hash runs in int64, masked to 32 bits after every multiply and
add, which gives the same bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _grid(height, width, device="cuda"):
    """Pixel-centred NDC grids (y up), aspect-corrected x."""
    ys = (torch.arange(height, device=device) + 0.5) / height * 2.0 - 1.0
    xs = (torch.arange(width, device=device) + 0.5) / width * 2.0 - 1.0
    y, x = torch.meshgrid(-ys, xs * (width / height), indexing="ij")
    return x, y


def _hash01(ix, iy, seed):
    """Integer hash of int64 pixel indices -> [0, 1) float32."""
    h = (ix * 374761393 + iy * 668265263) & _MASK
    h = ((h ^ (h >> 13)) * 1274126177 + seed) & _MASK
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) / torch.full(
        h.shape, float(0xFFFFFF), device=h.device)


def _indices(height, width, device):
    iy = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    ix = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return torch.broadcast_tensors(ix, iy)


def starfield(height: int, width: int, density: float = 0.002,
              seed: int = 0, device="cuda"):
    """Procedural star background: sparse white points with hashed
    brightness, on black.  (H, W, 3) float32."""
    ix, iy = _indices(height, width, device)
    r1 = _hash01(ix, iy, seed)
    r2 = _hash01(ix, iy, seed + 1)
    star = (r1 < density).to(torch.float32)
    mono = star * (0.4 + 0.6 * r2)
    return torch.stack([mono, mono, mono], dim=-1)


def starfield_envmap(height: int = 512, width: int = 1024,
                     density: float = 0.0015, seed: int = 0,
                     device="cuda"):
    """Equirect starfield panorama for Scene.env_map: sparse stars with
    hashed brightness and a blue-white temperature spread, plus a faint
    band along the equator.  (H, W, 3) float32."""
    ix, iy = _indices(height, width, device)
    r1 = _hash01(ix, iy, seed)
    r2 = _hash01(ix, iy, seed + 1)
    r3 = _hash01(ix, iy, seed + 2)
    star = (r1 < density).to(torch.float32)
    brightness = (0.3 + 0.7 * r2) * star
    # Temperature tint: hot stars slightly blue, cool slightly warm.
    tint_b = 0.85 + 0.3 * r3
    tint_r = 1.15 - 0.3 * r3
    rgb = torch.stack(
        [brightness * tint_r, brightness, brightness * tint_b], dim=-1
    )
    # Faint diffuse band around the equator (v = height/2).
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5
         ) / height
    band = 0.06 * torch.exp(-(((v - 0.5) / 0.08) ** 2))
    tint = torch.tensor([0.5, 0.55, 0.7], device=device)
    rgb = rgb + band[:, None, None] * tint
    return torch.clamp(rgb, 0.0, 1.0)
