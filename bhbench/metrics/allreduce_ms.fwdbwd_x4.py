"""Mean milliseconds, over the ranks and the untraced steps of the
window, from a rank's local end to its all_reduce's end (CUDA events,
parallel.mesh.step_timings()): the wait for the slowest rank, then the
transfer of [loss, dmass, dspin].  None without a traced run or its
ranks' timings."""

from bhbench.drivers import sharded_grad_loop


def read(run):
    steps = sharded_grad_loop.untraced_steps(run)
    if not steps:
        return None
    waits = [t["all_reduce_ms"] for ranks in steps for t in ranks]
    return sum(waits) / len(waits)
