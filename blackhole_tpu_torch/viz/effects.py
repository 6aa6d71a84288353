"""Screen-space visual effects: the procedural starfield, the lensing
warp, the black hole sprite, the preview composite and the particle
splat.

PyTorch counterpart of blackhole_tpu.viz.effects.  Images are (H, W, 3)
float tensors in [0, 1] on one device; the grid-based effects take a
device and a float dtype (float32 by default, as the JAX package's
arrays are without 64-bit mode).  The JAX hash multiplies in wrapping
uint32; torch's uint32 has few arithmetic ops, so the hash runs in
int64, masked to 32 bits after every multiply and add, which gives the
same bits.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import PI

_MASK = 0xFFFFFFFF


def _grid(height, width, device="cuda", dtype=torch.float32):
    """Pixel-centred NDC grids (y up), aspect-corrected x."""
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5
          ) / height * 2.0 - 1.0
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5
          ) / width * 2.0 - 1.0
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


def lensing_warp(image, center=(0.0, 0.0), strength: float = 0.15,
                 radius: float = 0.35, dtype=torch.float32):
    """Screen-space lensing distortion: pixels near the centre are pulled
    radially inward; a bilinear resample of the warped coordinates.  The
    grid is in dtype, on the image's device; the result in the image's
    dtype."""
    h, w = image.shape[:2]
    x, y = _grid(h, w, image.device, dtype)
    dx = x - center[0]
    dy = y - center[1]
    r = torch.sqrt(dx * dx + dy * dy) + 1e-6
    # Deflection falls off as 1/r outside `radius`, saturates inside.
    defl = strength * radius / torch.clamp(r, min=radius * 0.5)
    scale = 1.0 + defl
    sx = center[0] + dx * scale
    sy = center[1] + dy * scale
    # Back to pixel coordinates.
    px = (sx / (w / h) + 1.0) * 0.5 * w - 0.5
    py = (1.0 - (sy + 1.0) * 0.5) * h - 0.5

    px0 = torch.clamp(torch.floor(px).to(torch.int32), 0, w - 1)
    py0 = torch.clamp(torch.floor(py).to(torch.int32), 0, h - 1)
    px1 = torch.clamp(px0 + 1, 0, w - 1)
    py1 = torch.clamp(py0 + 1, 0, h - 1)
    fx = torch.clamp(px - px0, 0.0, 1.0)[..., None]
    fy = torch.clamp(py - py0, 0.0, 1.0)[..., None]
    px0, py0, px1, py1 = (t.long() for t in (px0, py0, px1, py1))

    def blend(a, b, f):
        # The weights are rounded to the image's dtype, as the JAX
        # package's weakly typed grid is.
        return a * (1 - f).to(a.dtype) + b * f.to(a.dtype)

    top = blend(image[py0, px0], image[py0, px1], fx)
    bot = blend(image[py1, px0], image[py1, px1], fx)
    return blend(top, bot, fy)


def blackhole_overlay(height: int, width: int, shadow_radius: float = 0.18,
                      spin: float = 0.0, disk: bool = True,
                      time: float = 0.0, device="cuda",
                      dtype=torch.float32):
    """Procedural 2-D black hole sprite: shadow disc, photon ring,
    lensing glow and a spiral-arm disk with a left/right Doppler tint
    and a frame-drag offset.  Returns (rgb, alpha): composite with
    out = rgb + (1 - alpha) * background."""
    x, y = _grid(height, width, device, dtype)
    # Frame dragging skews the apparent shadow centre.
    cx = 0.04 * spin
    dx, dy = x - cx, y
    r = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)

    shadow = torch.clamp(
        (shadow_radius - r) / (0.02 * shadow_radius + 1e-6), 0.0, 1.0)

    ring_r = 1.3 * shadow_radius
    photon_ring = torch.exp(-((r - ring_r) / (0.015 + 0.01 * spin)) ** 2)
    glow = 0.35 * torch.exp(-((r - shadow_radius) / 0.25) ** 2) * (
        r > shadow_radius)

    def tint(*rgb):
        return torch.tensor(rgb, dtype=dtype, device=device)

    # Glow: warm orange; photon ring: bright white-yellow.
    rgb = torch.zeros((height, width, 3), dtype=dtype, device=device)
    rgb = rgb + glow[..., None] * tint(1.0, 0.55, 0.2)
    rgb = rgb + photon_ring[..., None] * tint(1.0, 0.95, 0.8)

    if disk:
        # Spiral-arm accretion disk seen at a tilt: squash y by 0.35.
        er = torch.sqrt(dx * dx + (dy / 0.35) ** 2)
        in_disk = (er > 1.45 * shadow_radius) & (er < 3.6 * shadow_radius)
        spiral = 0.5 + 0.5 * torch.sin(6.0 * ang + 14.0 * er + 2.0 * time)
        radial_fade = torch.clamp(
            1.0 - (er - 1.45 * shadow_radius) / (2.2 * shadow_radius),
            0.0, 1.0)
        intensity = in_disk * (0.35 + 0.65 * spiral) * radial_fade
        # Doppler tint: the approaching side brighter and bluer.
        doppler = 1.0 + (0.45 + 0.4 * spin) * torch.sin(ang)
        col = torch.stack([
            intensity * 1.0 * doppler,
            intensity * 0.6 * doppler,
            intensity * (0.3 + 0.25 * torch.clamp(doppler - 1.0, 0, 1)),
        ], dim=-1)
        rgb = rgb + torch.clamp(col, 0.0, 2.0)

    alpha = torch.clamp(
        shadow + photon_ring + glow + (rgb.amax(dim=-1) > 0.02), 0.0, 1.0)
    rgb = rgb * (1.0 - shadow[..., None])  # the shadow is pure black
    return torch.clamp(rgb, 0.0, 1.0), alpha


def composite_preview(height: int, width: int, shadow_radius=0.18,
                      spin=0.0, time=0.0, seed=0, device="cuda",
                      dtype=torch.float32):
    """Full procedural preview frame: starfield background, lensing
    warp, overlay composite."""
    bg = starfield(height, width, seed=seed, device=device)
    bg = lensing_warp(bg, strength=0.25, radius=2.0 * shadow_radius,
                      dtype=dtype)
    rgb, alpha = blackhole_overlay(height, width, shadow_radius, spin,
                                   time=time, device=device, dtype=dtype)
    return torch.clamp(rgb + (1.0 - alpha[..., None]) * bg, 0.0, 1.0)


def particle_overlay(image, positions, temperatures, active, camera,
                     brightness: float = 0.8):
    """Splat particle point sprites onto a rendered frame.

    Particles are projected with the flat-space pinhole camera (no
    lensing) and added; colour is the blackbody palette of the particle
    temperature (white at temperature 0).  image (H, W, 3); positions
    (N, 3); temperatures (N,); active (N,) bool, all on one device.  The
    splat is index_put_ with accumulate, which adds in an unspecified
    order on CUDA (atomics): equal to the JAX package's within rounding.
    Returns the composited (H, W, 3) image."""
    from blackhole_tpu_torch.render import camera as cam_mod
    from blackhole_tpu_torch.render import shading

    h, w = image.shape[:2]
    forward, right, up = cam_mod.camera_basis(camera)
    rel = positions - camera.position
    z = rel @ forward
    x = rel @ right
    y = rel @ up

    fov_rad = camera.fov_deg * (PI / 180.0)
    plane_h = 2.0 * torch.tan(0.5 * fov_rad)
    plane_w = plane_h * (w / h)
    zs = torch.clamp(z, min=1e-3)
    ndc_x = (x / zs) / (0.5 * plane_w)
    ndc_y = (y / zs) / (0.5 * plane_h)
    # .to(int32) truncates toward zero, as JAX's astype does.
    px = ((ndc_x + 1.0) * 0.5 * w).to(torch.int32)
    py = ((1.0 - ndc_y) * 0.5 * h).to(torch.int32)

    visible = (active & (z > 0.1)
               & (px >= 0) & (px < w) & (py >= 0) & (py < h))
    px = torch.clamp(px, 0, w - 1).long()
    py = torch.clamp(py, 0, h - 1).long()

    white = torch.ones((3,), dtype=image.dtype, device=image.device)
    rgb = torch.where(
        (temperatures > 0.0)[:, None],
        shading.temperature_to_rgb(torch.clamp(temperatures, min=1.0)),
        white,
    )
    # Fade with distance like GL point attenuation.
    fade = brightness / (1.0 + 0.001 * zs * zs)
    splat = (rgb * fade[:, None]) * visible[:, None]
    out = image.index_put((py, px), splat.to(image.dtype), accumulate=True)
    return torch.clamp(out, 0.0, 1.0)
