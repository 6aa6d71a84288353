"""Mean milliseconds of a frame's work outside K1 (prepare, postprocess
and shading, the prepass's host side, the waits): bhbench.devtrace.
loop_host_ms with K1's kernels."""

from bhbench import devtrace


def read(run):
    return devtrace.loop_host_ms(run, lambda n: "trace_kernel" in n)
