"""Animation and progressive rendering.

PyTorch counterpart of blackhole_tpu.viz.animate: the progressive
quality ladder as successive renders, the orbit camera, and an orbit
animation written to numbered PNG frames.  Every render runs through
render.image.render_image on the scene's device (K1 on the card).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.render import image as image_mod
from blackhole_tpu_torch.viz import io as viz_io

# The reference visualizer's quality tiers: (resolution divisor, max
# steps).
QUALITY_LADDER = ((32, 20), (16, 30), (8, 40), (4, 50), (2, 50))


def tier_scene(scene: Scene, steps: int) -> Scene:
    """The scene of a ladder tier with a budget of `steps` (at least 20)
    steps: the integration step coarsened so the budget still covers the
    same path length (time_step * max_steps), trading accuracy for
    latency."""
    steps = max(steps, 20)
    dt_scale = max(1.0, scene.config.max_steps / steps)
    cfg = dataclasses.replace(
        scene.config,
        max_steps=steps,
        time_step=scene.config.time_step * dt_scale,
    )
    return dataclasses.replace(scene, config=cfg)


def upsample(img, width: int, height: int):
    """Nearest-neighbour upsample of a tier image by the integer factors
    width // w and height // h, cropped to (height, width)."""
    h, w = img.shape[:2]
    up = img.repeat_interleave(height // h, 0).repeat_interleave(
        width // w, 1)
    return up[:height, :width]


def tier_frame(scene: Scene, camera: Camera, width: int, height: int,
               divisor: int, steps: int):
    """One ladder tier: a render at 1/divisor resolution (at least 8
    pixels a side) and a coarsened step budget (tier_scene),
    nearest-upsampled to (height, width)."""
    w, h = max(8, width // divisor), max(8, height // divisor)
    img = image_mod.render_image(tier_scene(scene, steps), camera,
                                 width=w, height=h)
    return upsample(img, width, height)


def render_progressive(scene: Scene, camera: Camera, width: int,
                       height: int, ladder=QUALITY_LADDER):
    """Yield (divisor, image) pairs of increasing quality: each tier a
    tier_frame of the ladder."""
    for divisor, steps in ladder:
        yield divisor, tier_frame(scene, camera, width, height, divisor,
                                  steps)


def orbit_camera(distance: float, elevation_deg: float, azimuth_deg: float,
                 fov_deg: float = 40.0, device="cuda",
                 dtype=torch.float32) -> Camera:
    """Orbit-style camera aimed at the origin."""
    el = math.radians(elevation_deg)
    az = math.radians(azimuth_deg)
    pos = (
        distance * math.cos(el) * math.sin(az),
        -distance * math.cos(el) * math.cos(az),
        distance * math.sin(el),
    )
    return Camera.create(
        position=pos,
        direction=tuple(-p for p in pos),
        up=(0.0, 0.0, 1.0),
        fov_deg=fov_deg,
        device=device,
        dtype=dtype,
    )


def render_orbit_animation(
    scene: Scene,
    out_dir: str,
    n_frames: int = 24,
    width: int = 256,
    height: int = 256,
    distance: float = 35.0,
    elevation_deg: float = 18.0,
    fov_deg: float = 22.0,
    spp: int = 1,
    use_native_io: bool = True,
):
    """Render an azimuthal orbit sweep to out_dir/frame_%04d.png on the
    scene's device.

    Frames go to the native async writer (native/frameio.cpp) when it is
    available, so the device renders frame k+1 while the encoder thread
    writes frame k; otherwise viz.io writes each frame.  Returns the
    list of file paths."""
    from blackhole_tpu_torch.viz import native_io

    device = scene.blackhole.mass.device
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    writer = (
        native_io.AsyncFrameWriter(width, height)
        if use_native_io and native_io.available()
        else None
    )
    try:
        for k in range(n_frames):
            az = 360.0 * k / n_frames
            cam = orbit_camera(distance, elevation_deg, az, fov_deg,
                               device=device)
            img = image_mod.render_image(
                scene, cam, width=width, height=height, spp=spp
            ).cpu().numpy()
            path = os.path.join(out_dir, f"frame_{k:04d}.png")
            if writer is not None:
                writer.submit(img, path)
            else:
                viz_io.write_image(path, img)
            paths.append(path)
    finally:
        if writer is not None:
            writer.close()
    return paths
