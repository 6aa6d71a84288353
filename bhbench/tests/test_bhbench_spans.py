"""The readers of the program's spans on tiny CPU cells: each prints a
number in a traced run, but frame_device_idle_share.viewer, which needs
the card's kernels to place the render thread's frames; and each gives
None, without raising, with a program that keeps no spans."""

import pytest

from bhbench import harness, spans
from bhbench.tests import tiny

NEW = {
    "bench_fwdbwd_rk4": ["fwdgrad_jvp_ms.fwdbwd", "fwdgrad_primal_ms.fwdbwd"],
    "bench_fwd_rk4": ["kernel_prepare_ms.fwd", "kernel_finish_ms.fwd"],
    "viewer_drag": ["lock_wait_ms.viewer", "stale_frame_share.viewer"],
    "viewer_drag_particles": ["lock_wait_ms.viewer",
                              "stale_frame_share.viewer"],
}
NEEDS_CARD = ["frame_device_idle_share.viewer"]
# Seconds of a window that leaves untraced steps or frames after the
# traced part on the CPU (the profiler slows a tiny gradient step to
# ~15 s there).
SECONDS = {"bench_fwdbwd_rk4": 30.0, "bench_fwd_rk4": 1.5,
           "viewer_drag": 3.0, "viewer_drag_particles": 3.0}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_span_readers_read_the_tiny_cells(tmp_path, cell):
    rc, res, err = tiny.run(tmp_path, cell, seconds=SECONDS[cell], trace=1)
    assert rc == 0 and res["correct"] is True, err
    got = res["metrics"]
    for name in NEW[cell]:
        assert got[name]["value"] >= 0.0, name
    if cell.startswith("viewer"):
        assert got["lock_wait_ms.viewer"]["value"] > 0.0
        for name in NEEDS_CARD:
            assert name not in got  # no card: no kernel anchors the clock
    else:
        assert got[NEW[cell][0]]["value"] > 0.0


def test_span_readers_give_none_without_the_ring(monkeypatch):
    monkeypatch.setattr(spans, "ring", lambda: None)
    bench = harness.manifest()
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.trace = object()
    run.data["frame_timings"] = [{"seq": 1, "trace_ms": 1.0}]
    names = sorted({n for v in NEW.values() for n in v} | set(NEEDS_CARD))
    assert names == sorted(m["name"] for m in bench["per_layer"]
                           if m["name"] in names)
    assert [harness.reader(n)(run) for n in names] == [None] * len(names)
