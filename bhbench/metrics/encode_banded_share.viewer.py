"""The share, in %, of the frames the server published in the window
whose PNG was deflated in more than one band (`encode_bands` in
RenderServer.frame_timings(): viz/io.encode_png_banded on the server's
encoder threads).  None from a server that does not record it."""

from bhbench import spans


def read(run):
    rows = spans.frame_rows(run, "encode_bands")
    return 100.0 * sum(b > 1 for b in rows) / len(rows) if rows else None
