"""K2's share of its roofline in the traced window: the least FP32
operations of the steps its rays took (bhbench.arith's frozen count for
two tangents, the steps from the Hits of the traced steps) over the FP32
peak, against K2's device time by kernel name in the trace."""

from bhbench import arith


def read(run):
    steps = run.data.get("k2_ray_steps")
    if run.trace is None or not steps:
        return None
    device_s = run.trace.kernel_seconds(lambda n: "fwdgrad_kernel" in n)
    return arith.roofline_share(arith.least_seconds(2, steps), device_s)
