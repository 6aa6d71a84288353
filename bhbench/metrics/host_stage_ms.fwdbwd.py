"""Mean milliseconds of a gradient step's work outside the kernels (the
host stages, their jvps and the waits between): bhbench.devtrace.
loop_host_ms with K1's and K2's kernels."""

from bhbench import devtrace


def read(run):
    return devtrace.loop_host_ms(
        run, lambda n: "fwdgrad_kernel" in n or "trace_kernel" in n)
