"""The benchmark's yardstick arithmetic: peaks, least operation counts,
roofline shares, tails, spreads and the device's idle share.

Frozen here so that a change to the program cannot move it.
"""

from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM at its 700 W limit, FP32 outside the tensor cores and
# HBM3 bandwidth (NVIDIA's data sheet).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# The least FP32 operations (an FMA counts 2) one integration step of a
# ray needs with the disk on, by (tangents carried, adaptive step,
# crossing tracking): what the arithmetic of the step needs, whatever
# kernel runs it.  K1 is 0 tangents, the gradient kernel K2 2 (mass and
# spin).  Counted on the step's source with a counting float over the
# parity camera's rays; copied, not imported, from the program's
# smoke-run table of the same name.
LEAST_FLOPS_PER_STEP = {
    (0, False, False): 731.1, (0, True, False): 1433.1,
    (1, False, False): 2409.1, (1, True, False): 4577.5,
    (2, False, False): 4063.2, (2, True, False): 7694.2,
    (0, False, True): 736.9, (0, True, True): 1437.6,
    (1, False, True): 2442.1, (1, True, True): 4606.6,
    (2, False, True): 4122.6, (2, True, True): 7747.1,
}


def least_seconds(n_tangents: int, steps: float, adaptive=False,
                  track=False) -> float:
    """The least time the card could take for `steps` ray steps: their
    operations over the FP32 peak (their bytes, each ray's inputs read
    once and outputs written once, are under a thousandth of it)."""
    return (LEAST_FLOPS_PER_STEP[(n_tangents, adaptive, track)] * steps
            / FP32_FLOPS)


def roofline_share(least_s: float, device_s: float):
    """least / measured, in %; None where nothing was measured."""
    if not device_s or device_s <= 0.0 or not least_s:
        return None
    return 100.0 * least_s / device_s


def percentile(values, q: float) -> float:
    """The q-th percentile of values by linear interpolation between
    the closest ranks (numpy's default): every value counts."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance over the median (Python's exclusive
    quartiles), as a share."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps (start, end) of [start, end] that no interval covers."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [g for g in gaps if g[1] > g[0]]


def idle_share(intervals, start: float, end: float):
    """1 - busy / window over [start, end], in %; intervals are clipped
    to the window.  None for an empty window."""
    if end <= start:
        return None
    clipped = [(max(s, start), min(e, end)) for s, e in intervals
               if e > start and s < end]
    return 100.0 * (1.0 - union_seconds(clipped) / (end - start))
