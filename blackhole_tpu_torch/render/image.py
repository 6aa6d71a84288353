"""Image rendering: supersampling, depth-sorted tracing, accumulation.

PyTorch counterpart of blackhole_tpu.render.image (the forward path's
subset).  Rays live on the camera's device: on a GPU they go through
the CUDA geodesic kernel, on the CPU through its plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blackhole_tpu_torch.geom.types import Camera, Integrator, Scene
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import trace_kernel


def predicted_depth_order(scene: Scene, camera: Camera, width: int,
                          height: int, block: int = 8):
    """Depth-sort permutation for the (width x height) pixel rays.

    Traces a (width/block x height/block) prepass through the same
    kernel, widens each pixel's step count with a 3x3 max filter,
    nearest-upsamples it to full size and returns the stable argsort of
    its negation (deepest first).  Regrouping rays leaves every ray's
    result unchanged."""
    lw = max(width // block, 1)
    lh = max(height // block, 1)
    o, d = cam.generate_rays(camera, lw, lh)
    hit = trace_kernel.trace_rays_kernel(o.reshape(-1, 3), d.reshape(-1, 3),
                                         scene)
    s = hit.steps.reshape(lh, lw).to(torch.float32)
    p = F.pad(s[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    s3 = s
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s3 = torch.maximum(
                s3, p[1 + dy:1 + dy + lh, 1 + dx:1 + dx + lw]
            )
    pred = s3.repeat_interleave(block, 0).repeat_interleave(block, 1)
    pred = pred[:height, :width]
    if pred.shape != (height, width):  # size not a multiple of block
        pad = (0, width - pred.shape[1], 0, height - pred.shape[0])
        pred = F.pad(pred[None, None], pad, mode="replicate")[0, 0]
    return torch.argsort(-pred.reshape(-1), stable=True)


def trace_rays_fast(origins, directions, scene: Scene, engine: str = "auto",
                    order=None):
    """Forward ray tracing through the geodesic kernel.

    engine "auto" takes the kernel path for the RK4 and RKF45
    integrators: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors.  Other integrators need the XLA engine's
    counterpart, which is not ported yet, and raise.  A kernel that
    fails to build or launch raises; nothing falls back.

    order: optional depth-sort permutation (predicted_depth_order)."""
    if engine != "auto":
        raise NotImplementedError(f"engine {engine!r} is not ported yet")
    if scene.config.integrator not in (Integrator.RK4, Integrator.RKF45):
        raise NotImplementedError(
            f"integrator {scene.config.integrator!r} needs the XLA engine, "
            "not ported yet"
        )
    return trace_kernel.trace_rays_kernel(origins, directions, scene,
                                          order=order)


def render_image(scene: Scene, camera: Camera, width: int = 256,
                 height: int = 256, spp: int = 1, jitter: str = "halton",
                 engine: str = "auto", depth_sort: bool | None = None):
    """Render an RGB image (H, W, 3) in [0, 1] on the camera's device.

    spp samples per pixel with sub-pixel jitter.  depth_sort: feed the
    kernel a prepass depth permutation (predicted_depth_order); None
    turns it on for CUDA renders of at least 256x256.  One prepass
    serves every sample."""
    n_pix = width * height
    device = camera.position.device
    if depth_sort is None:
        depth_sort = device.type == "cuda" and n_pix >= 65536
    order = (predicted_depth_order(scene, camera, width, height)
             if depth_sort else None)
    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        ox, oy = cam.jitter_offsets(s, spp, method=jitter)
        origins, dirs = cam.generate_rays(camera, width, height, ox, oy)
        hit = trace_rays_fast(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                              scene, engine, order=order)
        acc = acc + hit.color.reshape(height, width, 3)
    return acc / spp


def temporal_accumulate(history, frame, frame_index, blend_factor=0.1,
                        max_frames=32):
    """Exponential temporal accumulation: alpha 1 on the first frame,
    0.5 on the second, then blend_factor; the index saturates at
    max_frames.  Returns (new_history, new_frame_index)."""
    idx = torch.as_tensor(frame_index, device=history.device)
    alpha = torch.where(
        idx == 0, 1.0, torch.where(idx == 1, 0.5, blend_factor)
    )
    alpha = torch.where(idx >= max_frames, blend_factor, alpha)
    out = history * (1.0 - alpha) + frame * alpha
    return out, torch.clamp(idx + 1, max=max_frames)
