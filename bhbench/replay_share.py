"""The share of a cell's frames whose K1 host stages replayed their CUDA
graphs: read by k1_replay_share.fwd and k1_replay_share.viewer from the
program's host spans (blackhole_tpu_torch.utils.profiling)."""

from __future__ import annotations

STAGES = ("kernel.prepare", "kernel.finish")


def graphed() -> bool:
    """Whether the program keeps CUDA graphs of K1's host stages (its
    trace_kernel counts their replays)."""
    try:
        from blackhole_tpu_torch.render import trace_kernel
    except ImportError:
        return False
    return hasattr(trace_kernel, "k1_replays")


def share(records, roots):
    """Percent of the roots holding a K1 host stage (a kernel.prepare or
    kernel.finish span at any depth beneath) whose every such stage
    holds a kernel.replay span: the frames whose stages all replayed
    instead of issuing each op.  None where no root holds a stage."""
    parent = {r.id: r.parent for r in records}
    wanted = {r.id for r in roots}

    def root_of(i):
        while i is not None and i not in wanted:
            i = parent.get(i)
        return i

    replayed = {r.parent for r in records if r.name == "kernel.replay"}
    held = {}  # root id -> whether every stage beneath replayed so far
    for r in records:
        if r.name in STAGES:
            root = root_of(r.parent)
            if root is not None:
                held[root] = held.get(root, True) and r.id in replayed
    if not held:
        return None
    return 100.0 * sum(held.values()) / len(held)
