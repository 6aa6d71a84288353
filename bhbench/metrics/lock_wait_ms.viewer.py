"""Mean lock_ms of the frames the server published in the window, from
RenderServer.frame_timings(): the render thread's waits for the
server's lock in a frame (its frame.lock spans), host clock."""

from bhbench import spans


def read(run):
    rows = spans.frame_rows(run, "lock_ms")
    return sum(rows) / len(rows) if rows else None
