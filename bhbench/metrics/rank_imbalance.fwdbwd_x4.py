"""How far the slowest rank holds a sharded gradient step back, in %:
the mean over the untraced steps of the window (each rank's
parallel.mesh.step_timings(), CUDA events) of the slowest rank's local
device time (its rows' prepass and value and gradient) over the ranks'
mean, less 1.  None without a traced run or its ranks' timings."""

from bhbench.drivers import sharded_grad_loop


def read(run):
    steps = sharded_grad_loop.untraced_steps(run)
    if not steps:
        return None
    shares = []
    for ranks in steps:
        local = [t["local_ms"] for t in ranks]
        shares.append(max(local) * len(local) / sum(local) - 1.0)
    return 100.0 * sum(shares) / len(shares)
