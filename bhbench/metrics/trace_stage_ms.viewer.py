"""Mean trace_ms of the frames the server published in the window,
from RenderServer.frame_timings(): the frame's trace stage (a tier's
render_image or an accumulation frame's trace_rays_fast), CUDA events."""


def read(run):
    rows = [t["trace_ms"] for t in run.data.get("frame_timings", ())
            if "trace_ms" in t]
    return sum(rows) / len(rows) if rows else None
