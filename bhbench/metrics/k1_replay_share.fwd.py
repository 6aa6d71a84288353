"""Percent of the frames (image.render spans) after the traced part of
the window whose every kernel.prepare and kernel.finish (the prepass's
and the render's) holds a kernel.replay span: the frames whose K1 host
stages replayed their CUDA graphs instead of issuing each op.  None for
a program that keeps no such graphs (no k1_replays counter in its
trace_kernel)."""

from bhbench import replay_share, spans


def read(run):
    prof = spans.ring()
    if prof is None or run.trace is None or not replay_share.graphed():
        return None
    records = prof.spans()
    roots = spans.untraced_roots(records, "image.render")
    return replay_share.share(records, roots) if roots else None
