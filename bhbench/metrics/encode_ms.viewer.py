"""Mean encode_ms of the frames the server published in the window,
from RenderServer.frame_timings(): the PNG encode on the host
(viz/io.encode_png), host clock."""


def read(run):
    rows = [t["encode_ms"] for t in run.data.get("frame_timings", ())
            if "encode_ms" in t]
    return sum(rows) / len(rows) if rows else None
