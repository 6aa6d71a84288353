"""Image rendering: supersampling, depth-sorted or chunked tracing,
temporal accumulation.

PyTorch counterpart of blackhole_tpu.render.image.  Rays live on the
camera's device.  Two engines trace them: the geodesic kernel (the CUDA
kernel on a GPU, its plain version on the CPU) and the XLA engine
(render.trace.trace_rays, plain torch on either device).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F

from blackhole_tpu_torch.geom.types import Camera, Hit, Integrator, Scene
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import trace, trace_kernel
from blackhole_tpu_torch.utils import profiling

_renders = itertools.count()  # render_image's calls: its span's key


def predicted_depth_order(scene: Scene, camera: Camera, width: int,
                          height: int, block: int = 8, rows=None):
    """Depth-sort permutation for the (width x height) pixel rays.

    Traces a (width/block x height/block) prepass through the same
    kernel, widens each pixel's step count with a 3x3 max filter,
    nearest-upsamples it to full size and returns the stable argsort of
    its negation (deepest first).  Regrouping rays leaves every ray's
    result unchanged.

    rows: a slice of image rows (a rank's block): the prepass traces
    only the prepass rows that cover them, the filter widens over those
    alone (replicating the block's edges), and the permutation is of
    the block's rays, (rows.stop - rows.start) * width of them.  None:
    the whole image."""
    with profiling.span("image.depth_order"):
        return _depth_order(scene, camera, width, height, block,
                            rows or slice(0, height))


def _depth_order(scene, camera, width, height, block, rows):
    lw = max(width // block, 1)
    lh = max(height // block, 1)
    # The prepass rows over the block; image rows past lh * block take
    # the last one.
    l0 = min(rows.start // block, lh - 1)
    l1 = min(-(-rows.stop // block), lh)
    dev = camera.position.device
    o, d = cam.generate_rays_for_rows(camera, lw, lh,
                                      torch.arange(l0, l1, device=dev))
    hit = trace_kernel.trace_rays_kernel(o.reshape(-1, 3), d.reshape(-1, 3),
                                         scene)
    n = l1 - l0
    s = hit.steps.reshape(n, lw).to(torch.float32)
    p = F.pad(s[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    s3 = s
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s3 = torch.maximum(
                s3, p[1 + dy:1 + dy + n, 1 + dx:1 + dx + lw]
            )
    ys = torch.clamp(torch.arange(rows.start, rows.stop, device=dev) // block,
                     max=lh - 1) - l0
    xs = torch.clamp(torch.arange(width, device=dev) // block, max=lw - 1)
    pred = s3[ys][:, xs]
    return torch.argsort(-pred.reshape(-1), stable=True)


def predicted_depth_order_rays(origins, directions, scene: Scene,
                               stride: int = 64):
    """Depth-sort permutation for an arbitrary flat ray batch: every
    stride-th ray traced through the geodesic kernel, its step count
    widened by the max of its two neighbours, nearest-assigned back and
    stable-argsorted deepest first.  Regrouping rays leaves every ray's
    result unchanged."""
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    n = o.shape[0]
    hit = trace_kernel.trace_rays_kernel(o[::stride], d[::stride], scene)
    s = hit.steps.to(torch.float32)
    s = torch.maximum(s, torch.maximum(torch.roll(s, 1), torch.roll(s, -1)))
    pred = s.repeat_interleave(stride)[:n]
    return torch.argsort(-pred, stable=True)


_ENGINES = ("auto", "xla")


def _resolve_engine(engine: str, scene: Scene) -> str:
    """"kernel" or "xla": "auto" takes the geodesic kernel for the RK4
    and RKF45 integrators and the XLA engine for the others, as the
    JAX package's auto does on a TPU."""
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
    if engine == "auto" and scene.config.integrator in (Integrator.RK4,
                                                        Integrator.RKF45):
        return "kernel"
    return "xla"


def trace_rays_fast(origins, directions, scene: Scene, engine: str = "auto",
                    order=None):
    """Forward ray tracing through the chosen engine.

    engine "auto": the geodesic kernel for RK4 and RKF45 (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors), the
    XLA engine (trace.trace_rays, plain torch on the rays' device) for
    LEAPFROG and YOSHIDA; "xla": the XLA engine for every integrator.
    A kernel that fails to build or launch raises; nothing falls back.

    order: optional depth-sort permutation (predicted_depth_order) for
    the kernel; the XLA engine ignores it."""
    if _resolve_engine(engine, scene) == "xla":
        return trace.trace_rays(origins, directions, scene)
    return trace_kernel.trace_rays_kernel(origins, directions, scene,
                                          order=order)


def render_image(scene: Scene, camera: Camera, width: int = 256,
                 height: int = 256, spp: int = 1, jitter: str = "halton",
                 chunks: int = 1, engine: str = "auto",
                 depth_sort: bool | None = None):
    """Render an RGB image (H, W, 3) in [0, 1] on the camera's device.

    spp samples per pixel with sub-pixel jitter.  chunks: with engine
    "xla", trace the pixels in this many sequential chunks, each
    stopping when its own rays are done.  depth_sort: feed the kernel a
    prepass depth permutation (predicted_depth_order); None turns it on
    for kernel renders on a GPU of at least 256x256.  One prepass
    serves every sample."""
    with profiling.span("image.render", next(_renders)):
        return _render(scene, camera, width, height, spp, jitter, chunks,
                       engine, depth_sort)


def _render(scene, camera, width, height, spp, jitter, chunks, engine,
            depth_sort):
    n_pix = width * height
    if n_pix % chunks:
        raise ValueError("chunks must divide width * height")
    device = camera.position.device
    kernel = _resolve_engine(engine, scene) == "kernel"
    if depth_sort is None:
        depth_sort = kernel and device.type == "cuda" and n_pix >= 65536
    order = (predicted_depth_order(scene, camera, width, height)
             if depth_sort and kernel else None)

    def trace_flat(origins, dirs):
        if chunks == 1 or engine != "xla":
            return trace_rays_fast(origins, dirs, scene, engine, order=order)
        hits = [trace.trace_rays(o, d, scene) for o, d in
                zip(origins.chunk(chunks), dirs.chunk(chunks))]
        return Hit(*(torch.cat([getattr(h, f.name) for h in hits])
                     for f in dataclasses.fields(Hit)))

    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        ox, oy = cam.jitter_offsets(s, spp, method=jitter)
        origins, dirs = cam.generate_rays(camera, width, height, ox, oy)
        hit = trace_flat(origins.reshape(-1, 3), dirs.reshape(-1, 3))
        acc = acc + hit.color.reshape(height, width, 3)
    return acc / spp


def render_hits(scene: Scene, camera: Camera, width: int, height: int):
    """The full Hit record grid (H, W) of a render, by the XLA engine."""
    origins, dirs = cam.generate_rays(camera, width, height)
    return trace.trace_rays(origins, dirs, scene)


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


def render_accumulated(scene: Scene, camera: Camera, width, height,
                       n_frames=8, blend_factor=0.1, max_frames=32):
    """Progressive accumulation of n_frames frames by the XLA engine,
    frame s at the s-th Halton jitter offset, blended by
    temporal_accumulate."""
    device = camera.position.device
    history = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=device)
    idx = torch.zeros((), dtype=torch.int32, device=device)
    for s in range(n_frames):
        ox, oy = cam.jitter_offsets(s, n_frames)
        origins, dirs = cam.generate_rays(camera, width, height, ox, oy)
        hit = trace.trace_rays(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                               scene)
        frame = hit.color.reshape(height, width, 3)
        history, idx = temporal_accumulate(history, frame, idx, blend_factor,
                                           max_frames)
    return history
