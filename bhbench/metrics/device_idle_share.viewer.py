"""The card's idle share in the traced window, in %: 1 - (the union of
its kernels, copies and fills) / (the window's length).  The server's
render thread is not the thread that started the profiler, so its host
operations are not recorded and do not slow it."""

from bhbench import arith


def read(run):
    if run.trace is None:
        return None
    return arith.idle_share(run.trace.busy, *run.trace.window)
