"""A world of ranks on this host, for the examples, the tests, the
scaling harness and chip_smoke.py.

run_world spawns world_size processes (torch.multiprocessing, spawn),
joins them into one process group through a file:// store in a
temporary directory (no TCP port to pick), runs fn(mesh, *args) on
each and returns the ranks' results in rank order.  It never hangs and
never returns part of a world: if a rank raises, exits without a result
or passes the deadline, every rank is stopped and run_world raises with
that rank's traceback.
"""

from __future__ import annotations

import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from blackhole_tpu_torch.parallel import mesh


def run_world(fn, world_size: int, backend: str | None = None,
              device: str = "cuda", args: tuple = (),
              timeout_s: float = 600.0) -> list:
    """[fn(mesh, *args) for each rank], run on world_size spawned ranks.

    fn must be importable by name (a module-level function) and return
    host data (numbers, numpy arrays, CPU tensors): it is pickled back.
    backend: NCCL for ranks with a card each, gloo for CPU ranks and for
    ranks that share a card (NCCL refuses two ranks on one card), unless
    given.
    device: each rank's mesh device (parallel.mesh.make_mesh).  Each
    rank uses one intra-op thread.  timeout_s bounds the whole call and
    every collective."""
    if backend is None:
        backend = ("nccl" if torch.device(device).type == "cuda"
                   and world_size <= torch.cuda.device_count() else "gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, backend, device,
                                   init, args, timeout_s, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(results, procs, deadline)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)


def _collect(results, procs, deadline) -> list:
    """Every rank's result, or raise at the first failure."""
    out = {}
    while len(out) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            for rank, p in enumerate(procs):
                if rank not in out and p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {rank} exited with code "
                                       f"{p.exitcode} without a result")
            if time.monotonic() > deadline:
                late = [r for r in range(len(procs)) if r not in out]
                raise TimeoutError(f"ranks {late} passed the deadline")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        out[rank] = pickle.loads(payload)
    return [out[r] for r in range(len(procs))]


def _rank_main(fn, rank, world_size, backend, device, init_method, args,
               timeout_s, results):
    torch.set_num_threads(1)
    try:
        mesh.initialize_distributed(init_method, world_size, rank, backend,
                                    timeout_s)
        out = fn(mesh.make_mesh(world_size, device), *args)
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
