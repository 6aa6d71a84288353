"""The readers of k1_replay_share.fwd and k1_replay_share.viewer on
synthetic span records: the share of the frames whose K1 host stages
(every kernel.prepare and kernel.finish, the prepass's and the
render's) replayed, and None where the program keeps no graphs or no
spans."""

import types

from bhbench import harness, spans
from blackhole_tpu_torch.render import trace_kernel
from blackhole_tpu_torch.utils import profiling

FWD = "k1_replay_share.fwd"
VIEWER = "k1_replay_share.viewer"


def _frames(root, kinds, traced_first=True):
    """Records of frames `root`, keyed 1, 2, ...: the first traced (with
    traced_first), then one per entry of kinds, a list of the children
    ("replay", "capture" or None) of the frame's stages, each stage a
    kernel.prepare, kernel.finish pair nested in an image.render (the
    prepass's pair inside an image.depth_order).  A frame of no stages
    is one that does not trace."""
    records, t = [], 0

    def add(name, parent, start, end, key=None, traced=False):
        records.append(profiling.Record(name, key, parent, 1, start, end,
                                        len(records), traced))
        return len(records) - 1

    first = [[("replay", "replay")]] if traced_first else []
    for i, kind in enumerate(first + list(kinds)):
        top = add(root, None, t, t + 1000, key=i + 1,
                  traced=traced_first and i == 0)
        inner = top if root == "image.render" else add(
            "image.render", top, t + 1, t + 999)
        for j, pair in enumerate(kind):
            s0 = t + 10 + 200 * j
            holder = (add("image.depth_order", inner, s0, s0 + 150)
                      if j == 0 and len(kind) > 1 else inner)
            for k, (stage, child) in enumerate(zip(
                    ("kernel.prepare", "kernel.finish"), pair)):
                a = s0 + 5 + 70 * k
                s = add(stage, holder, a, a + 50)
                if child is not None:
                    add(f"kernel.{child}", s, a + 5, a + 45)
        t += 2000
    return records


def _read(monkeypatch, name, records, seqs=None):
    ring = types.SimpleNamespace(spans=lambda: records)
    monkeypatch.setattr(spans, "ring", lambda: ring)
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.trace = object()
    if seqs is not None:
        run.data["frame_timings"] = [{"seq": s} for s in seqs]
    return harness.reader(name)(run)


ALL = [("replay", "replay")] * 2  # prepass and render, both replayed


def test_fwd_share_counts_frames_whose_every_stage_replayed(monkeypatch):
    records = _frames("image.render", [
        ALL, [("replay", "replay"), ("replay", "capture")],
        [("capture", "capture")] * 2, ALL, [(None, None)] * 2])
    assert _read(monkeypatch, FWD, records) == 40.0
    assert _read(monkeypatch, FWD, _frames("image.render",
                                           [ALL] * 3)) == 100.0
    # The traced frame alone: no untraced frame to read.
    assert _read(monkeypatch, FWD, _frames("image.render", [])) is None


def test_viewer_share_counts_window_frames_that_trace(monkeypatch):
    records = _frames("frame", [
        ALL, [("replay", "replay")], [], [("capture", "replay")], ALL],
        traced_first=False)
    # Frames 1-5 published in the window; frame 3 traces nothing.
    assert _read(monkeypatch, VIEWER, records, [1, 2, 3, 4, 5]) == 75.0
    assert _read(monkeypatch, VIEWER, records, [1, 2, 3]) == 100.0
    assert _read(monkeypatch, VIEWER, records, [3]) is None
    assert _read(monkeypatch, VIEWER, records, []) is None


def test_shares_are_none_without_graphs_or_spans(monkeypatch):
    fwd = _frames("image.render", [ALL])
    frames = _frames("frame", [ALL], traced_first=False)
    monkeypatch.delattr(trace_kernel, "k1_replays")
    assert _read(monkeypatch, FWD, fwd) is None
    assert _read(monkeypatch, VIEWER, frames, [1]) is None
    monkeypatch.undo()
    assert _read(monkeypatch, VIEWER, frames, [1]) == 100.0
    monkeypatch.setattr(spans, "ring", lambda: None)
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.trace = object()
    run.data["frame_timings"] = [{"seq": 1}]
    assert harness.reader(FWD)(run) is None
    assert harness.reader(VIEWER)(run) is None
    names = [m["name"] for m in harness.manifest()["per_layer"]]
    assert FWD in names and VIEWER in names
