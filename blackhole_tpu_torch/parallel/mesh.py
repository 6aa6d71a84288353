"""Rank-mesh parallelism: image rows sharded across ranks, gradients
all-reduced.

PyTorch counterpart of blackhole_tpu.parallel.mesh.  Its 1-D device
mesh over the "rays" axis becomes a torch.distributed world: each rank
traces its own block of image rows with no communication, one
all_gather assembles the full image on every rank, and the sharded
gradient is one all_reduce(SUM) of the loss and every parameter
gradient (the scene parameters are replicated, as under shard_map):
by reverse mode through the XLA engine (loss_and_grad_sharded), or by
forward mode through the gradient kernel K2 on each rank's rows
(scene_value_and_grad_sharded).

The backend is NCCL for ranks on a card and gloo for ranks on the CPU,
unless the caller asks for another.  gloo carries host tensors: a gloo
rank on a card (two ranks sharing one card, where NCCL refuses) copies
each collective's buffer to the host and back (Mesh.host_staged).
Without an initialised process group a mesh is a world of one rank and
every collective here is the identity.

Counters: collectives (issued here) and collective_bytes (each rank's
buffer bytes put into them); step_timings() gives the sharded forward
gradient's per-call device times.

parallel.launch.run_world spawns a world of ranks on this host.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from blackhole_tpu_torch.geom.types import Camera, Scene
from blackhole_tpu_torch.grad import diff_trace, fast_grad, inverse
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image
from blackhole_tpu_torch.utils import profiling

# Collectives issued here since the process started, and the bytes of
# this rank's buffers put into them.
collectives = 0
collective_bytes = 0
# (call index, profiling.Stages) of scene_value_and_grad_sharded's calls,
# the newest 4096: read by step_timings().
_steps = collections.deque(maxlen=4096)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A world of `size` ranks seen from rank `rank`: its process group
    (None for a world of one rank without one) and the rank's device.
    host_staged: collectives go through host memory (gloo on a card)."""

    group: object
    rank: int
    size: int
    device: torch.device
    host_staged: bool = False


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           timeout_s: float | None = None) -> None:
    """Join a process group (no-op without init_method, as the JAX
    package's is without a coordinator).  backend: NCCL where a card is
    present, else gloo, unless given."""
    if init_method is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def make_mesh(n_ranks: int | None = None, device=None) -> Mesh:
    """The world as a mesh.  n_ranks, if given, must be the world's size.
    device: the rank's device; default (or "cuda") the card of local
    rank % device count (LOCAL_RANK, else the rank), "cpu" for a CPU
    rank.  A card becomes the process's current device: the kernels'
    launches, the CUDA graphs' captures and NCCL's collectives all run
    on the current device's streams."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
        backend = dist.get_backend()
    else:
        group, rank, size, backend = None, 0, 1, None
    if n_ranks is not None and n_ranks != size:
        raise ValueError(f"a mesh of {n_ranks} ranks needs a world of "
                         f"{n_ranks} ranks; this one has {size}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device for this rank: pass "
                               "device='cpu' for a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, device,
                host_staged=backend == "gloo" and device.type == "cuda")


def _check_divisible(height: int, n: int):
    if height % n != 0:
        raise ValueError(
            f"image height {height} must be divisible by mesh size {n}"
        )


def _rows(height: int, mesh: Mesh) -> slice:
    _check_divisible(height, mesh.size)
    per = height // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _count(t) -> None:
    global collectives, collective_bytes
    collectives += 1
    collective_bytes += t.numel() * t.element_size()


def _all_gather_rows(block, mesh: Mesh):
    """Every rank's block, concatenated along the first axis in rank
    order, on every rank."""
    if mesh.group is None:
        return block
    t = block.contiguous()
    t = t.cpu() if mesh.host_staged else t
    _count(t)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).to(block.device)


def _all_reduce_sum(flat, mesh: Mesh):
    """The sum over ranks of a 1-D tensor, on every rank."""
    if mesh.group is None:
        return flat
    t = flat.cpu() if mesh.host_staged else flat.clone()
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.to(flat.device)


def render_image_sharded(scene: Scene, camera: Camera, width: int,
                         height: int, mesh: Mesh, spp: int = 1,
                         engine: str = "xla", depth_sort: bool = False):
    """Forward render with rows sharded over the mesh.

    Each rank traces rows [r H/n, (r+1) H/n) of the same generate_rays as
    the single-device render (its rays are bit for bit the unsharded
    ones), with no communication, and an all_gather assembles the full
    (H, W, 3) image on every rank.  engine: "xla" (the XLA engine) or
    "auto" (the geodesic kernel per shard: K1 on a card; the JAX
    package's "pallas").  depth_sort (kernel engine only): each rank
    orders ITS rays by image.predicted_depth_order_rays."""
    rows = _rows(height, mesh)
    kernel = image._resolve_engine(engine, scene) == "kernel"
    acc = None
    for s in range(spp):
        ox, oy = cam.jitter_offsets(s, spp)
        origins, dirs = cam.generate_rays(camera, width, height, ox, oy)
        o = origins[rows].reshape(-1, 3)
        d = dirs[rows].reshape(-1, 3)
        order = (image.predicted_depth_order_rays(o, d, scene)
                 if depth_sort and kernel else None)
        hit = image.trace_rays_fast(o, d, scene, engine, order=order)
        frame = hit.color.reshape(-1, width, 3)
        acc = frame if acc is None else acc + frame
    return _all_gather_rows(acc / spp, mesh)


def loss_and_grad_sharded(params: dict, target, template_scene: Scene,
                          template_camera: Camera, width: int, height: int,
                          mesh: Mesh):
    """Distributed value and gradient of the inverse-rendering loss
    0.5 mean((render - target)^2).

    Each rank unpacks the (replicated) params, generates the rays of its
    rows (so camera gradients flow through ray generation on every
    rank), differentiates 0.5 sum((img - t)^2) over its block by reverse
    mode (diff_trace), and one all_reduce(SUM) covers the loss and every
    gradient, divided by target.numel().  Returns (loss, grads) with
    grads a dict like params; params are not modified."""
    rows = _rows(height, mesh)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    s, c = inverse.unpack_params(leaves, template_scene, template_camera)
    row_ids = torch.arange(rows.start, rows.stop, device=c.position.device)
    origins, dirs = cam.generate_rays_for_rows(c, width, height, row_ids)
    hit = diff_trace.trace_rays_diff(origins.reshape(-1, 3),
                                     dirs.reshape(-1, 3), s)
    t_blk = target[rows]
    img = hit.color.reshape(t_blk.shape)
    loss = 0.5 * torch.sum((img - t_blk) ** 2)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    grads = [torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, grads)]
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.reshape(-1).to(loss.dtype) for g in grads])
    flat = _all_reduce_sum(flat, mesh) / target.numel()
    out, at = {}, 1
    for k, g in zip(names, grads):
        out[k] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
        at += g.numel()
    return flat[0], out


def make_train_step_sharded(width: int, height: int, mesh: Mesh):
    """step(params, optimizer, target, template_scene, template_camera)
    -> (params, optimizer, loss): one distributed optimiser step in
    place, as inverse.make_train_step's: params' tensors are the
    optimizer's parameters, and every rank applies the same all-reduced
    gradient, so the params stay replicated."""

    def step(params, optimizer, target, template_scene, template_camera):
        loss, grads = loss_and_grad_sharded(params, target, template_scene,
                                            template_camera, width, height,
                                            mesh)
        for k, p in params.items():
            p.grad = grads[k]
        optimizer.step()
        return params, optimizer, loss

    return step


def scene_value_and_grad_sharded(loss_of_hit, scene_fn, camera: Camera,
                                 width: int, height: int, mesh: Mesh,
                                 tangent_clip=fast_grad.TANGENT_CLIP):
    """Forward-mode value and gradient of an image's loss with rows
    sharded over the mesh: fast_grad.scene_value_and_grad (one pass of
    K2 on a card) over each rank's rows, one all_reduce(SUM).

    scene_fn(params) -> Scene; loss_of_hit(hit) -> scalar must be a sum
    over the hit's rays divided by the WHOLE image's ray count (the
    bench loss sum(colour) / (3 W H) is), so that the ranks' values add
    up to the whole image's.  Each rank generates the rays of its rows
    [r H/n, (r+1) H/n) once (bit for bit the unsharded ones); at every
    call it orders them by its rows' own prepass
    (image.predicted_depth_order over the block) and traces them.
    Returns g(params) -> (loss, grads), grads a pytree like params, the
    same on every rank.  Without a process group (a world of one rank)
    g returns scene_value_and_grad's own result: no copy, no collective.

    Spans: mesh.value_and_grad (key: the call index) over mesh.local
    (the prepass and scene_value_and_grad) and mesh.all_reduce; each
    call's device times go to step_timings()."""
    rows = _rows(height, mesh)
    row_ids = torch.arange(rows.start, rows.stop,
                           device=camera.position.device)
    origins, dirs = cam.generate_rays_for_rows(camera, width, height,
                                               row_ids)
    origins, dirs = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    vg = fast_grad.scene_value_and_grad(loss_of_hit, scene_fn,
                                        tangent_clip=tangent_clip)
    calls = itertools.count()

    def value_and_grad(params):
        i = next(calls)
        with profiling.span("mesh.value_and_grad", i):
            stages = profiling.Stages(mesh.device, prefix=None)
            with profiling.span("mesh.local"):
                order = image.predicted_depth_order(
                    scene_fn(params), camera, width, height, rows=rows)
                loss, grads = vg(params, origins, dirs, order)
            stages.mark("local")
            if mesh.group is not None:
                with profiling.span("mesh.all_reduce"):
                    loss, grads = _sum_over_ranks(loss, grads, mesh)
            stages.mark("all_reduce")
            _steps.append((i, stages))
            return loss, grads

    return value_and_grad


def _sum_over_ranks(loss, grads, mesh: Mesh):
    """(loss, grads) summed over the ranks by one all_reduce of
    [loss, every gradient component]."""
    leaves, spec = pytree.tree_flatten(grads)
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.reshape(-1).to(loss.dtype) for g in leaves])
    flat = _all_reduce_sum(flat, mesh)
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0], pytree.tree_unflatten(out, spec)


def step_timings() -> list:
    """[{"call", "local_ms", "all_reduce_ms"}] of scene_value_and_grad_
    sharded's calls in this process (the newest 4096), oldest first:
    device time (CUDA events, the host clock on the CPU) from the call's
    start to the end of its local work (the prepass and the rank's
    value and gradient), and from there to the end of its all_reduce
    (the wait for the slowest rank, then the transfer; 0 without a
    collective).  Waits for the card's queued work first."""
    profiling.synchronize()
    return [{"call": i, **stages.ms()} for i, stages in list(_steps)]
