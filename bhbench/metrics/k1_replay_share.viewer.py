"""Percent of the served frames published in the window (the render
thread's frame spans, keyed by seq) that trace through K1 and whose every
kernel.prepare and kernel.finish holds a kernel.replay span: the frames
whose K1 host stages replayed their CUDA graphs instead of issuing each
op.  A replay share below 100 means the session captured anew.  None
for a program that keeps no such graphs (no k1_replays counter in its
trace_kernel)."""

from bhbench import replay_share, spans


def read(run):
    prof = spans.ring()
    if prof is None or not replay_share.graphed():
        return None
    seqs = {t["seq"] for t in run.data.get("frame_timings", ())}
    records = prof.spans()
    roots = [r for r in records if r.name == "frame" and r.parent is None
             and r.key in seqs]
    return replay_share.share(records, roots) if roots else None
