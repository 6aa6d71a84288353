"""Step-bucketed gradients: a backward pass as long as each chunk needs.

PyTorch counterpart of blackhole_tpu.grad.bucketed.  The reverse-mode
trace (diff_trace) runs a fixed number of steps, so a backward pass
over an image would take max_steps for every ray although most chunks
finish much sooner.  A forward sizing pass (image.trace_rays_fast: one
launch of the geodesic kernel over all rays on a GPU, its plain version
on the CPU) measures each chunk's step need; each chunk's gradient then
runs at the smallest budget of a geometric ladder that covers it.  A
ray that finished in s steps is unchanged by any budget >= s, so the
result equals the full-budget gradient.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from blackhole_tpu_torch.geom.types import Scene
from blackhole_tpu_torch.grad import diff_trace
from blackhole_tpu_torch.render import image


# The most rays one reverse pass takes when chunks share a bucket: an
# eager step costs nearly the same for 65,536 rays as for 786,432 (it is
# bound by the host's launches; PERF.md), and 786,432 rays of 1,000
# steps peak near 50 GiB of device memory.
GROUP_RAYS = 1 << 20


def _buckets_for(max_steps: int):
    """Geometric bucket ladder capped at max_steps, e.g. 1000 ->
    (62, 125, 250, 500, 1000)."""
    out = [max_steps]
    while out[-1] > 64:
        out.append(out[-1] // 2)
    return tuple(sorted(out))


def _chunk_steps(o, d, scene: Scene):
    """The most steps any ray of each chunk needs: o, d (chunks, m, 3)
    -> (chunks,) int, from one forward trace of every ray (rays are
    independent, so one pass over all chunks equals one per chunk)."""
    with torch.no_grad():
        hit = image.trace_rays_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                    scene)
    return hit.steps.reshape(o.shape[0], -1).amax(dim=1)


def grad_over_chunks(scene_fn, params, origins, dirs, loss_fn, loss_args=(),
                     chunks: int = 32, buckets=None,
                     cache: dict | None = None):
    """Value and gradient by chunks, each in its step bucket.

    scene_fn(params) -> Scene, differentiable in params (a pytree of
    tensors); loss_fn(colors, chunk_index, *loss_args) -> the chunk's
    scalar contribution, the total loss being the sum over chunks.
    origins, dirs: (N, 3).  Returns (loss, grads), grads shaped like
    params.  Chunks that share a bucket go through one reverse pass of
    at most GROUP_RAYS rays (at least one chunk): rays are independent,
    so this equals one pass per chunk up to the order of the sums.
    cache is accepted for the JAX package's signature; eager torch
    compiles nothing, so it stays as given."""
    n = origins.shape[0]
    if n % chunks:
        raise ValueError("chunks must divide the ray count")
    o = origins.reshape(chunks, n // chunks, 3)
    d = dirs.reshape(chunks, n // chunks, 3)
    leaves, spec = pytree.tree_flatten(params)
    scene0 = scene_fn(pytree.tree_unflatten(
        [t.detach() for t in leaves], spec))
    if buckets is None:
        buckets = _buckets_for(scene0.config.max_steps)

    # Phase 1: the sizing pass.
    need = _chunk_steps(o, d, scene0).tolist()

    def bucket_of(s):
        for b in buckets:
            if s <= b:
                return b
        return buckets[-1]

    # Phase 2: each group's value and gradient at its bucket.
    bucket = [bucket_of(int(s) + 1) for s in need]
    per = max(1, GROUP_RAYS // (n // chunks))
    groups = []
    for b in sorted(set(bucket)):
        idx = [c for c in range(chunks) if bucket[c] == b]
        groups += [(b, idx[i:i + per]) for i in range(0, len(idx), per)]
    total_loss = 0.0
    total = None
    for b, idx in groups:
        xs = [t.detach().requires_grad_(True) for t in leaves]
        s = scene_fn(pytree.tree_unflatten(xs, spec))
        s = dataclasses.replace(
            s, config=dataclasses.replace(s.config, max_steps=b))
        hit = diff_trace.trace_rays_diff(o[idx].reshape(-1, 3),
                                         d[idx].reshape(-1, 3), s)
        colors = hit.color.view(len(idx), -1, 3)
        loss_g = sum(loss_fn(colors[j], c, *loss_args)
                     for j, c in enumerate(idx))
        grads_g = torch.autograd.grad(loss_g, xs, allow_unused=True)
        grads_g = [torch.zeros_like(x) if g is None else g
                   for x, g in zip(xs, grads_g)]
        total_loss = total_loss + loss_g.detach()
        total = (grads_g if total is None
                 else [a + g for a, g in zip(total, grads_g)])
    return total_loss, pytree.tree_unflatten(total, spec)
