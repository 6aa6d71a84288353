"""A world of ranks on this host, for the examples, the tests, the
scaling harness, chip_smoke.py and a calling process that is itself a
rank.

run_world spawns world_size processes (torch.multiprocessing, spawn),
joins them into one process group through a file:// store in a
temporary directory (no TCP port to pick), runs fn(mesh, *args) on
each and returns the ranks' results in rank order.  It never hangs and
never returns part of a world: if a rank raises, exits without a result
or passes the deadline, every rank is stopped and run_world raises with
that rank's traceback.

joined_world makes the calling process rank 0 of such a world and
spawns ranks 1.. the same way, with the same guarantees (see there).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pickle
import queue
import signal
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from blackhole_tpu_torch.parallel import mesh

# How long a joined world's caller may stay in the world after a spawned
# rank failed before its process is ended: a gloo collective fails at
# once when a peer goes, an NCCL one waits on the card.
GRACE_S = 15.0


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
    backend = _backend(backend, device, world_size)
    with _spawned(fn, range(world_size), world_size, backend, device, args,
                  timeout_s) as (procs, results, _, deadline):
        return _collect(results, procs, deadline)


class World:
    """What joined_world yields: the calling process's mesh (rank 0) and,
    once the block has ended, the spawned ranks' results in rank order."""

    def __init__(self, mesh_: mesh.Mesh):
        self.mesh = mesh_
        self.results = None


@contextlib.contextmanager
def joined_world(fn, world_size: int, backend: str | None = None,
                 device: str = "cuda", args: tuple = (),
                 timeout_s: float = 600.0):
    """The calling process as rank 0 of a world of world_size ranks:
    ranks 1.. are spawned as under run_world (the same fn, backend,
    device, args and timeout_s rules), and the block runs rank 0's part
    on the yielded World's mesh.  When the block ends the call waits for
    ranks 1..'s results (World.results), leaves the process group and
    reaps them.

    It never hangs and never leaves part of a world: a spawned rank that
    raises, exits without a result or passes the deadline stops every
    spawned rank, and the block's next collective fails; if the caller
    is still in the block GRACE_S later (an NCCL collective waits on the
    card for a rank that is gone), the process prints that rank's
    failure and exits with code 1.  A block that raises stops every
    spawned rank and raises, with a spawned rank's failure first where
    there was one; the process group is then left as it is."""
    backend = _backend(backend, device, world_size)
    with _spawned(fn, range(1, world_size), world_size, backend, device,
                  args, timeout_s) as (procs, results, init, deadline):
        watch = _Watch(results, procs, deadline)
        watch.start()
        try:
            mesh.initialize_distributed(init, world_size, 0, backend,
                                        timeout_s)
            world = World(mesh.make_mesh(world_size, device))
            yield world
        except BaseException as exc:
            watch.left.set()
            # A spawned rank's failure, if one is on its way: the likely
            # cause of the caller's (its collective lost a peer).
            watch.join(1.0)
            failure = watch.error
            _stop(procs)
            if failure is not None:
                raise failure from exc
            raise
        watch.left.set()
        watch.join(max(deadline - time.monotonic(), 0.0) + 5.0)
        if watch.error is not None:
            raise watch.error
        world.results = watch.out
        dist.destroy_process_group()


def _backend(backend, device, world_size):
    if backend is not None:
        return backend
    return ("nccl" if torch.device(device).type == "cuda"
            and world_size <= torch.cuda.device_count() else "gloo")


@contextlib.contextmanager
def _spawned(fn, ranks, world_size, backend, device, args, timeout_s):
    """Ranks `ranks` of the world started, each in _rank_main; yields
    ({rank: process}, their result queue, the store's init_method, the
    deadline) and kills and joins every one of them when the block
    ends."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs = {rank: ctx.Process(target=_rank_main, daemon=True,
                                   args=(fn, rank, world_size, backend,
                                         device, init, args, timeout_s,
                                         results))
                 for rank in ranks}
        for p in procs.values():
            p.start()
        try:
            yield procs, results, init, deadline
        finally:
            _stop(procs)
            for p in procs.values():
                p.join(timeout=30)


def _stop(procs) -> None:
    for p in procs.values():
        if p.is_alive():
            p.kill()


def _collect(results, procs, deadline) -> list:
    """Every rank's result in rank order, or raise at the first
    failure."""
    out = {}
    while len(out) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            for rank, p in procs.items():
                if rank not in out and p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {rank} exited with code "
                                       f"{p.exitcode} without a result")
            if time.monotonic() > deadline:
                late = [r for r in procs if r not in out]
                raise TimeoutError(f"ranks {late} passed the deadline")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        out[rank] = pickle.loads(payload)
    return [out[r] for r in sorted(procs)]


class _Watch(threading.Thread):
    """_collect beside the calling rank: the spawned ranks' results, or
    their first failure, on which it stops every spawned rank and ends
    the process if the caller has not left the world (`left`) GRACE_S
    later."""

    def __init__(self, results, procs, deadline):
        super().__init__(daemon=True)
        self._args = (results, procs, deadline)
        self._procs = procs
        self.left = threading.Event()
        self.out = None
        self.error = None

    def run(self):
        try:
            self.out = _collect(*self._args)
            return
        except Exception as exc:  # handed to the caller, which raises it
            self.error = exc
        _stop(self._procs)
        if not self.left.wait(GRACE_S):
            print(f"{self.error}\nrank 0 is still waiting in the world "
                  f"{GRACE_S:g} s later: exiting", file=sys.stderr,
                  flush=True)
            os._exit(1)


def _rank_main(fn, rank, world_size, backend, device, init_method, args,
               timeout_s, results):
    _die_with_parent()
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


def _die_with_parent() -> None:
    """On Linux, the rank is killed when the process that spawned it
    ends, however that ends (PR_SET_PDEATHSIG): no rank outlives its
    world's caller."""
    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass
