"""The card's idle share inside the served frames, in %: of the time in
the render thread's frame spans in the traced window (placed on the
trace's clock by the K1 launches they enclose), the part in which the
card ran no kernel, copy or fill.  Unlike device_idle_share.viewer it
leaves out the converged rest between drags."""

from bhbench import spans


def read(run):
    idle = spans.frame_idle(run)
    if idle is None or idle["frame_s"] <= 0.0:
        return None
    return 100.0 * idle["idle_s"] / idle["frame_s"]
