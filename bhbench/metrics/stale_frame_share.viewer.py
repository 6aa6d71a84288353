"""The share, in %, of the frames the server published in the window
that a command superseded while they were rendered (`stale` in
RenderServer.frame_timings(): the count of applied commands differs
between the frame's start and its publication)."""

from bhbench import spans


def read(run):
    rows = spans.frame_rows(run, "stale")
    return 100.0 * sum(map(bool, rows)) / len(rows) if rows else None
