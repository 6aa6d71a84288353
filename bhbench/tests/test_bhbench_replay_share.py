"""The reader of fwdgrad_replay_share.fwdbwd on synthetic span records:
the share of the untraced gradient steps whose prepare and finish both
replayed, and None where the program keeps no graphs or no spans."""

import types

from bhbench import harness, spans
from blackhole_tpu_torch.render import trace_kernel
from blackhole_tpu_torch.utils import profiling

NAME = "fwdgrad_replay_share.fwdbwd"


def _steps(kinds):
    """Records of one traced step, then one step per entry of kinds:
    (prepare's child, finish's child), each "replay", "capture" or None."""
    records, t = [], 0

    def add(name, parent, start, end, traced=False):
        records.append(profiling.Record(name, None, parent, 1, start, end,
                                        len(records), traced))
        return len(records) - 1

    for i, kind in enumerate([("replay", "replay")] + list(kinds)):
        root = add("grad.value_and_grad", None, t, t + 100, traced=i == 0)
        for j, (stage, child) in enumerate(zip(
                ("fwdgrad.prepare", "fwdgrad.finish"), kind)):
            s = add(stage, root, t + 10 + 40 * j, t + 40 + 40 * j)
            if child is not None:
                add(f"fwdgrad.{child}", s, t + 15 + 40 * j, t + 35 + 40 * j)
        t += 200
    return records


def _read(monkeypatch, records):
    ring = types.SimpleNamespace(spans=lambda: records)
    monkeypatch.setattr(spans, "ring", lambda: ring)
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.trace = object()
    return harness.reader(NAME)(run)


def test_replay_share_counts_steps_that_replayed_both_stages(monkeypatch):
    records = _steps([("replay", "replay"), ("replay", "capture"),
                      ("capture", "capture"), ("replay", "replay"),
                      (None, None)])
    assert _read(monkeypatch, records) == 40.0
    assert _read(monkeypatch, _steps([("replay", "replay")] * 3)) == 100.0
    # The traced step alone: no untraced step to read.
    assert _read(monkeypatch, _steps([])) is None


def test_replay_share_is_none_without_graphs_or_spans(monkeypatch):
    records = _steps([("replay", "replay")])
    monkeypatch.delattr(trace_kernel, "fwdgrad_replays")
    assert _read(monkeypatch, records) is None
    monkeypatch.undo()
    monkeypatch.setattr(spans, "ring", lambda: None)
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.trace = object()
    assert harness.reader(NAME)(run) is None
    assert NAME in [m["name"] for m in harness.manifest()["per_layer"]]
