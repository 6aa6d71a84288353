"""Rank 0's card's idle share in %, per step of the sharded closed loop:
bhbench.devtrace.loop_idle_share with NCCL's kernels counted as idle
(they spin on the card while rank 0 waits for the other ranks)."""

from bhbench import arith


def read(run):
    items = run.data.get("traced_items")
    wall = run.data.get("wall_per_item_s")
    if run.trace is None or not items or not wall:
        return None
    nccl = {(s, e) for n, s, e in run.trace.kernels if "nccl" in n.lower()}
    w0, w1 = run.trace.window
    busy = arith.union_seconds([(max(s, w0), min(e, w1))
                                for s, e in run.trace.busy
                                if (s, e) not in nccl and e > w0 and s < w1])
    return 100.0 * (1.0 - busy / items / wall)
