"""K2's share of its roofline on rank 0's card in the traced window:
k2_roofline_share.fwdbwd's reading (the least FP32 operations of the
steps of rank 0's rays, from its Hits, over the FP32 peak, against K2's
device time by kernel name), rank 0 being the process the profiler
traces."""

from bhbench import harness


def read(run):
    return harness.reader("k2_roofline_share.fwdbwd")(run)
