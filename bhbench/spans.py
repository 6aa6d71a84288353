"""The program's host spans, read after a run's window by the per-layer
metrics that need them.

The program keeps every span it closes in a ring
(blackhole_tpu_torch.utils.profiling: span, spans, dropped, place).  A
program without that ring gives None here, and so does every reader.
The bench cells' loops run on the profiler's thread: their steps or
frames after the traced part are the root spans that began after the
last traced one.  The viewer's frames run on the server's render
thread, which the profiler does not record: they are placed on the
trace's clock by the K1 launches they enclose.
"""

from __future__ import annotations

import bisect


def ring():
    """The program's profiling module where it keeps spans, else None."""
    try:
        from blackhole_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "place") else None


def untraced_roots(records, name):
    """The root spans `name` that began after the last traced one closed:
    the steps or frames of the window's untraced part ([] where none was
    traced, or the ring let the traced ones go)."""
    roots = [r for r in records if r.name == name and r.parent is None]
    last = max((r.end for r in roots if r.traced), default=None)
    if last is None:
        return []
    return [r for r in roots if r.start > last]


def per_root_ms(run, root, names, own=False):
    """Mean ms, over the untraced part's `root` spans, of the summed spans
    named in `names` beneath each (their self time with own).  None
    without a traced run or such roots."""
    prof = ring()
    if prof is None or run.trace is None:
        return None
    records = prof.spans()
    roots = untraced_roots(records, root)
    if not roots:
        return None
    parent = {r.id: r.parent for r in records}
    inside = {r.id for r in roots}

    def under(r):
        p = r.parent
        while p is not None and p not in inside:
            p = parent.get(p)
        return p is not None

    length = prof.self_ns(records) if own else None
    total = sum(length[r.id] if own else r.end - r.start
                for r in records if r.name in names and under(r))
    return total / len(roots) / 1e6


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle(busy, starts, t0, t1):
    """The pieces of [t0, t1] that no merged busy interval covers."""
    i = max(bisect.bisect_right(starts, t0) - 1, 0)
    gaps, t = [], t0
    while i < len(busy) and busy[i][0] < t1:
        s, e = busy[i]
        if s > t:
            gaps.append((t, min(s, t1)))
        t = max(t, e)
        i += 1
    if t < t1:
        gaps.append((t, t1))
    return gaps


def frame_idle(run):
    """The card's idle time inside the render thread's published frames
    (root spans `frame` with their seq as key), clipped to the traced
    window and placed on its clock: {"frames", "frame_s", "idle_s",
    "by_stage": {child span name (the frame's stages), or "-" for none:
    idle s}}.  None without a trace, an anchor for the clock, or the
    window's spans."""
    prof = ring()
    if prof is None or run.trace is None:
        return None
    records = prof.spans()
    off = prof.place(records,
                     [(n, s * 1e6, e * 1e6) for n, s, e in run.trace.kernels],
                     [(n, s * 1e6, e * 1e6) for n, s, e in run.trace.host])
    if off is None:
        return None
    w0, w1 = run.trace.window

    def at(t):
        return t / 1e9 + off / 1e6

    if prof.dropped() and (not records
                           or at(min(r.start for r in records)) > w0):
        return None
    busy = _merged(run.trace.busy)
    starts = [b[0] for b in busy]
    children = {}
    for r in records:
        children.setdefault(r.parent, []).append(r)
    out = {"frames": 0, "frame_s": 0.0, "idle_s": 0.0, "by_stage": {}}
    for f in records:
        if f.name != "frame" or f.parent is not None or f.key is None:
            continue
        t0, t1 = max(at(f.start), w0), min(at(f.end), w1)
        if t1 <= t0:
            continue
        out["frames"] += 1
        out["frame_s"] += t1 - t0
        kids = [(at(c.start), at(c.end), c.name)
                for c in children.get(f.id, ())]
        for g0, g1 in _idle(busy, starts, t0, t1):
            out["idle_s"] += g1 - g0
            rest = g1 - g0
            for c0, c1, name in kids:
                piece = min(g1, c1) - max(g0, c0)
                if piece > 0:
                    out["by_stage"][name] = out["by_stage"].get(
                        name, 0.0) + piece
                    rest -= piece
            if rest > 0:
                out["by_stage"]["-"] = out["by_stage"].get("-", 0.0) + rest
    return out if out["frames"] else None


def frame_rows(run, key):
    """The frame_timings() rows of the frames published in the window
    that carry `key` (none from a server that does not record it)."""
    return [t[key] for t in run.data.get("frame_timings", ()) if key in t]
