"""The card's idle share in %, per frame of bench_fwd_rk4's closed loop
(bhbench.devtrace.loop_idle_share)."""

from bhbench import devtrace


def read(run):
    return devtrace.loop_idle_share(run)
