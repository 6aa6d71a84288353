"""Edge-contrast adaptive supersampling.

PyTorch counterpart of blackhole_tpu.render.adaptive: a uniform base
pass, an edge map (edge_factor), and extra Halton-jittered samples for
the top edge_fraction of pixels by edge factor, traced as one batch per
sample and averaged into the image.  Total rays = n_pix * (base_spp +
edge_fraction * extra_spp).  Both passes trace through
image.render_image / image.trace_rays_fast (K1 on the card).
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image as image_mod


def edge_factor(image, edge_threshold: float = 0.1):
    """Per-pixel edge factor in [0, 1].

    image: (H, W, 3).  For each interior pixel: the max over the 8
    neighbours of the channel-averaged absolute colour difference,
    divided by edge_threshold and clamped at 1.  The 2-pixel image
    border returns 1.0."""
    h, w = image.shape[:2]
    max_diff = torch.zeros(image.shape[:2], dtype=image.dtype,
                           device=image.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = torch.roll(image, (-dy, -dx), dims=(0, 1))
            diff = torch.mean(torch.abs(image - shifted), dim=-1)
            max_diff = torch.maximum(max_diff, diff)
    factor = torch.clamp(max_diff / edge_threshold, max=1.0)
    # Border frame (x <= 1, x >= w-2, y <= 1, y >= h-2) -> 1.0.
    ys = torch.arange(h, device=image.device)[:, None]
    xs = torch.arange(w, device=image.device)[None, :]
    border = (xs <= 1) | (xs >= w - 2) | (ys <= 1) | (ys >= h - 2)
    return torch.where(border, torch.ones_like(factor), factor)


def select_pixels(edges, k: int):
    """Flat indices of the k largest edge factors, largest first; equal
    values in increasing index order.  The edge map is full of ties (the
    border and saturated edges at 1.0, flat regions at 0), and this is
    jax.lax.top_k's tie rule; torch.topk promises no order among ties,
    so the selection is a stable descending sort, on every device."""
    return torch.sort(edges.reshape(-1), descending=True,
                      stable=True)[1][:k]


def render_adaptive(
    scene: Scene,
    camera: Camera,
    width: int = 256,
    height: int = 256,
    base_spp: int = 1,
    extra_spp: int = 4,
    edge_fraction: float = 0.125,
    edge_threshold: float = 0.1,
    engine: str = "auto",
):
    """Two-pass edge-adaptive render on the camera's device; returns
    (image, edge_map).

    Ray budget: width*height*(base_spp + edge_fraction*extra_spp)."""
    n_pix = width * height
    k = max(1, int(round(edge_fraction * n_pix)))

    base = image_mod.render_image(
        scene, camera, width, height, spp=base_spp, engine=engine
    )
    edges = edge_factor(base, edge_threshold)

    flat_idx = select_pixels(edges, k)
    pix_y = flat_idx // width
    pix_x = flat_idx % width

    acc = base.reshape(-1, 3)[flat_idx] * base_spp
    for s in range(extra_spp):
        # Continue the Halton sequence where the base pass stopped so
        # refinement samples never repeat base-sample positions.
        ox, oy = cam.jitter_offsets(base_spp + s, base_spp + extra_spp)
        o, d = cam.generate_rays_for_pixels(
            camera, width, height, pix_x, pix_y, ox, oy
        )
        hit = image_mod.trace_rays_fast(o, d, scene, engine)
        acc = acc + hit.color
    refined = acc / (base_spp + extra_spp)

    img = base.reshape(-1, 3).index_copy(0, flat_idx, refined).reshape(
        height, width, 3
    )
    return img, edges
