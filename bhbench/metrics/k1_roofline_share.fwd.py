"""K1's share of its roofline in the traced window: the least FP32
operations of the steps the frames' rays need (the render launch and its
prepass; per frame from the reference's trace of the checked frames,
which the scene's symmetry about the spin axis makes the same at every
azimuth) over the FP32 peak, against K1's device time by kernel name."""

from bhbench import arith


def read(run):
    per_frame = run.data.get("ray_steps_per_frame")
    frames = run.data.get("traced_items")
    if run.trace is None or not per_frame or not frames:
        return None
    device_s = run.trace.kernel_seconds(lambda n: "trace_kernel" in n)
    return arith.roofline_share(arith.least_seconds(0, per_frame * frames),
                                device_s)
