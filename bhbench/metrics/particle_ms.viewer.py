"""Mean particles_ms of the frames the server published in the window,
from RenderServer.frame_timings(): the particle step and splat
(viewer.overlay_particles), CUDA events."""


def read(run):
    rows = [t["particles_ms"] for t in run.data.get("frame_timings", ())
            if "particles_ms" in t]
    return sum(rows) / len(rows) if rows else None
