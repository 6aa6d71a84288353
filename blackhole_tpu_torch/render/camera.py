"""Pinhole camera ray generation with sub-pixel jitter.

PyTorch counterpart of blackhole_tpu.render.camera.  Rays come out on
the camera's device.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import PI
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import Camera, Jitter


def halton(index, base: int):
    """Radical-inverse Halton sequence over an int tensor (32 digits
    cover any int32 index)."""
    i = torch.as_tensor(index, dtype=torch.int32)
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.ones(i.shape, dtype=torch.float32, device=i.device)
    for _ in range(32):
        f = f / base
        result = result + f * (i % base).to(torch.float32)
        i = i // base
    return result


def jitter_offsets(sample_idx, samples_per_pixel, method=Jitter.HALTON,
                   strength=1.0, generator=None):
    """Sub-pixel offsets in [0,1)^2 for one sample index.

    method RANDOM draws from `generator` (a torch.Generator); its
    numbers differ from jax.random's for the same seed."""
    if method == Jitter.NONE or samples_per_pixel <= 1:
        ox = torch.tensor(0.5)
        oy = torch.tensor(0.5)
    elif method == Jitter.REGULAR_GRID:
        grid = max(int(samples_per_pixel**0.5), 1)
        ox = torch.as_tensor((sample_idx % grid + 0.5) / grid,
                             dtype=torch.float32)
        oy = torch.as_tensor((sample_idx // grid + 0.5) / grid,
                             dtype=torch.float32)
    elif method == Jitter.RANDOM:
        ox, oy = torch.rand(2, generator=generator)
    else:  # HALTON and BLUE_NOISE (both use Halton, as in the JAX package)
        ox = halton(sample_idx, 2)
        oy = halton(sample_idx, 3)
    ox = 0.5 + (ox - 0.5) * strength
    oy = 0.5 + (oy - 0.5) * strength
    return ox, oy


def camera_basis(camera: Camera):
    """Orthonormal (forward, right, up) basis."""
    forward = coords.normalize(camera.direction)
    right = coords.normalize(torch.linalg.cross(forward, camera.up))
    up = torch.linalg.cross(right, forward)
    return forward, right, up


def generate_rays_for_rows(camera: Camera, width: int, height: int, rows,
                           offset_x=0.5, offset_y=0.5):
    """Primary rays for the given image rows (int tensor (R,)).
    Returns (origins, directions), each (R, W, 3)."""
    device = camera.position.device
    forward, right, up = camera_basis(camera)
    aspect = width / height
    fov_rad = camera.fov_deg * (PI / 180.0)
    plane_h = 2.0 * torch.tan(0.5 * fov_rad)
    plane_w = plane_h * aspect

    px = torch.arange(width, dtype=torch.float32, device=device)
    py = torch.as_tensor(rows, device=device).to(torch.float32)
    offset_x = torch.as_tensor(offset_x, dtype=torch.float32, device=device)
    offset_y = torch.as_tensor(offset_y, dtype=torch.float32, device=device)
    # The pixel grid is float32 and the plane's extent takes the
    # camera's dtype, as JAX promotes (torch would keep a 0-d factor's
    # product in float32).
    ndc_x = (2.0 * (px[None, :] + offset_x) / width - 1.0).to(
        plane_w.dtype) * plane_w
    ndc_y = (1.0 - 2.0 * (py[:, None] + offset_y) / height).to(
        plane_h.dtype) * plane_h

    d = (
        forward[None, None, :]
        + ndc_x[..., None] * right[None, None, :]
        + ndc_y[..., None] * up[None, None, :]
    )
    directions = coords.normalize(d)
    origins = torch.broadcast_to(camera.position, directions.shape)
    return origins, directions


def generate_rays_for_pixels(camera: Camera, width: int, height: int,
                             pix_x, pix_y, offset_x=0.5, offset_y=0.5):
    """Primary rays for an arbitrary pixel subset: pix_x, pix_y int
    tensors (N,), offsets scalars or (N,).  Returns (origins,
    directions), each (N, 3)."""
    device = camera.position.device
    forward, right, up = camera_basis(camera)
    aspect = width / height
    fov_rad = camera.fov_deg * (PI / 180.0)
    plane_h = 2.0 * torch.tan(0.5 * fov_rad)
    plane_w = plane_h * aspect

    px = torch.as_tensor(pix_x, device=device).to(torch.float32)
    py = torch.as_tensor(pix_y, device=device).to(torch.float32)
    offset_x = torch.as_tensor(offset_x, dtype=torch.float32, device=device)
    offset_y = torch.as_tensor(offset_y, dtype=torch.float32, device=device)
    ndc_x = (2.0 * (px + offset_x) / width - 1.0).to(plane_w.dtype) * plane_w
    ndc_y = (1.0 - 2.0 * (py + offset_y) / height).to(plane_h.dtype) * plane_h
    d = (
        forward[None, :]
        + ndc_x[..., None] * right[None, :]
        + ndc_y[..., None] * up[None, :]
    )
    directions = coords.normalize(d)
    origins = torch.broadcast_to(camera.position, directions.shape)
    return origins, directions


def generate_rays(camera: Camera, width: int, height: int,
                  offset_x=0.5, offset_y=0.5):
    """Primary rays for a width x height image, each (H, W, 3); row 0
    is the top of the image."""
    rows = torch.arange(height, device=camera.position.device)
    return generate_rays_for_rows(camera, width, height, rows, offset_x,
                                  offset_y)
