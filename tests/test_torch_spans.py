"""The port's host spans (utils.profiling): the ring, the clock that
places spans on a Chrome trace, and the spans of the gradient path and
of the render server, on the CPU."""

import dataclasses
import itertools
import json
import sys
import threading

import pytest
import torch

from blackhole_tpu_torch.geom import types
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import camera as cam_mod
from blackhole_tpu_torch.utils import profiling
from blackhole_tpu_torch.viz import animate, server, viewer

torch.set_num_threads(1)  # see tests/test_torch_step.py


@pytest.fixture
def ring():
    profiling.clear()
    yield
    profiling.clear()


def _named(name):
    return [r for r in profiling.spans() if r.name == name]


def test_nesting_parent_key_and_self_time(ring):
    with profiling.span("outer", 7) as outer:
        with profiling.span("a"):
            pass
        with profiling.span("b", "k") as b:
            b.key = "set inside"
    (o,), (a,), (bb,) = _named("outer"), _named("a"), _named("b")
    assert o.parent is None and o.key == 7
    assert a.parent == o.id and bb.parent == o.id and bb.key == "set inside"
    assert o.start <= a.start <= a.end <= bb.start <= bb.end <= o.end
    assert {r.thread for r in (o, a, bb)} == {threading.get_ident()}
    own = profiling.self_ns(profiling.spans())
    assert own[o.id] == (o.end - o.start) - (a.end - a.start) - (
        bb.end - bb.start)
    assert own[a.id] == a.end - a.start and outer.ns == o.end - o.start
    # The ring is a ring of closings: children close first.
    assert [r.name for r in profiling.spans()] == ["a", "b", "outer"]


def test_span_closes_on_an_exception(ring):
    with pytest.raises(ValueError):
        with profiling.span("raises"):
            raise ValueError("x")
    with profiling.span("after"):
        pass
    (after,) = _named("after")
    assert len(_named("raises")) == 1 and after.parent is None


def test_ring_keeps_the_newest_and_counts_the_rest(ring):
    cap, extra = profiling.CAPACITY, 37
    for i in range(cap + extra):
        with profiling.span("s", i):
            pass
    records = profiling.spans()
    assert len(records) == cap and profiling.dropped() == extra
    assert records[0].key == extra and records[-1].key == cap + extra - 1
    assert [r.id for r in records[:2]] == [extra, extra + 1]
    # Past twice the capacity the ring is cut back; the count holds.
    for i in range(cap + extra, 2 * cap + 2 * extra):
        with profiling.span("s", i):
            pass
    records = profiling.spans()
    assert len(records) == cap and profiling.dropped() == cap + 2 * extra
    assert records[0].key == cap + 2 * extra
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_ring_under_threads_loses_no_count(ring):
    per, n = 17_000, 8  # 136,000 spans: the ring is cut back meanwhile
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with profiling.span("outer", k):
                    with profiling.span("inner", i):
                        pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    records = profiling.spans()
    assert len(records) + profiling.dropped() == 2 * per * n
    assert len(records) == profiling.CAPACITY
    ids = {r.id: r for r in records}
    for r in records:
        if r.name == "inner" and r.parent is not None:
            p = ids[r.parent]
            assert p.name == "outer" and p.thread == r.thread


def test_other_thread_is_recorded_but_not_in_the_profilers_trace(
        ring, tmp_path):
    seen = {}

    def work():
        seen["profiled"] = torch._C._autograd._profiler_enabled()
        with profiling.span("worker"):
            torch.ones(16).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=60)
    assert not th.is_alive()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    (main,), (worker,) = _named("main"), _named("worker")
    assert seen["profiled"] is False
    assert main.traced and not worker.traced
    assert worker.thread != main.thread and worker.parent is None
    assert "main" in names and "worker" not in names


_ids = itertools.count(1)


def _record(name, start_ns, end_ns, traced=False):
    return profiling.Record(name, None, None, 1, start_ns, end_ns,
                            next(_ids), traced)


def _launches(offset_us, latencies_us, gaps_us, n_spans, first):
    """Launch spans at irregular times and the trace's kernels of the
    spans first.. (offset_us from the spans' clock, each kernel
    latencies_us after its span's start)."""
    t, spans = 1_000_000_000, []
    for g in gaps_us[:n_spans]:
        t += int(g * 1e3)
        spans.append(_record("kernel.k1", t, t + 5_000))
    kernels = [("void trace_kernel<true>", s.start / 1e3 + offset_us + lat,
                s.start / 1e3 + offset_us + lat + 900.0)
               for s, lat in zip(spans[first:], latencies_us)]
    return spans, kernels


def test_place_recovers_the_offset_from_launches():
    gen = torch.Generator().manual_seed(5)
    gaps = (2_000 + 30_000 * torch.rand(40, generator=gen)).tolist()
    lat = (60 * torch.rand(20, generator=gen)).tolist()
    lat[7] = 0.0  # the least latency: the offset is exact there
    off = 1.448e12
    spans, kernels = _launches(off, lat, gaps, 40, first=9)
    got = profiling.place(spans, kernels)
    assert got is not None and abs(got - off) < 1.0
    # Every kernel starts at or after its launch span once placed.
    starts = sorted(s.start for s in spans)[9:29]
    assert all(k[1] >= s / 1e3 + got - 1e-6 for k, s in zip(kernels, starts))
    # A K2 family placed with it must agree.
    k2 = _record("kernel.k2", spans[-1].end + 3_000_000,
                 spans[-1].end + 3_001_000)
    both = profiling.place(spans + [k2], kernels + [
        ("fwdgrad_kernel<2>", k2.start / 1e3 + off + 4.0, 0.0)])
    assert both is not None and abs(both - off) < 1.0


def test_place_agrees_with_annotation_anchors_and_needs_an_anchor():
    off = -2.5e6
    starts = [10_000, 2_300_000, 3_100_000, 7_900_000, 9_000_000,
              15_200_000]
    spans = [_record("image.render", t, t + 700_000, traced=True)
             for t in starts]
    ann = [("image.render", s.start / 1e3 + off + 3.0,
            s.end / 1e3 + off - 2.0) for s in spans]
    got = profiling.place(spans, [], ann)
    assert got is not None and abs(got - off) < 5.0
    # The launches are checked by the annotations: no kernel may then
    # start before its launch span.
    launch = [_record("kernel.k1", s.start + 100_000, s.start + 101_000)
              for s in spans]
    for lat, want in ((2.0, got), (500.0, got), (-500.0, None)):
        kernels = [("trace_kernel", s.start / 1e3 + off + lat, 0.0)
                   for s in launch[1:5]]
        assert profiling.place(spans + launch, kernels, ann) == want, lat
    # Two kernels are too few to align without the annotations.
    two = [("trace_kernel", s.start / 1e3 + off + 2.0, 0.0)
           for s in launch[1:3]]
    assert profiling.place(spans + launch, two, ann) == got
    assert profiling.place(launch, two) is None
    # Nothing anchors the clock.
    assert profiling.place(spans, [], []) is None
    assert profiling.place([_record("x", 0, 1)], [], ann) is None
    assert profiling.place(launch[:1], two) is None


def _tiny_scene():
    scene = types.Scene(
        types.BlackHole.create(1.0, 0.9, device="cpu"),
        types.Disk.create(6.0, 20.0, device="cpu"),
        types.SimConfig.create(time_step=0.5, max_ray_distance=150.0,
                               max_steps=8, device="cpu"),
        disk_enabled=True)
    camera = types.Camera.create(position=(0.0, -35.0, 12.0),
                                 direction=(0.0, 35.0, -12.0),
                                 up=(0.0, 0.0, 1.0), fov_deg=60.0,
                                 device="cpu")
    return scene, camera


def test_scene_value_and_grad_spans(ring):
    scene, camera = _tiny_scene()
    o, d = cam_mod.generate_rays(camera, 3, 2)

    def scene_fn(p):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"], spin=p["spin"]))

    vg = fast_grad.scene_value_and_grad(
        lambda hit: hit.color.sum() / hit.color.numel(), scene_fn)
    p = {"mass": torch.tensor(1.0), "spin": torch.tensor(0.9)}
    first = vg(p, o.reshape(-1, 3), d.reshape(-1, 3))
    profiling.clear()
    loss, grads = vg(p, o.reshape(-1, 3), d.reshape(-1, 3))
    assert torch.equal(loss, first[0])
    assert all(torch.equal(grads[k], first[1][k]) for k in grads)
    records = profiling.spans()
    (root,) = _named("grad.value_and_grad")
    assert root.parent is None and root.key == 1  # the second call
    (prep,), (fin,) = _named("fwdgrad.prepare"), _named("fwdgrad.finish")
    assert prep.parent == root.id and fin.parent == root.id
    jvps = _named("fwdgrad.jvp")
    assert [(j.parent, j.key) for j in jvps] == [
        (prep.id, 0), (prep.id, 1), (fin.id, 0), (fin.id, 1)]
    # On the CPU the planes pass is the plain version: no launch span.
    assert {r.name for r in records} == {
        "grad.value_and_grad", "fwdgrad.prepare", "fwdgrad.finish",
        "fwdgrad.jvp"}
    own = profiling.self_ns(records)
    assert own[prep.id] == (prep.end - prep.start) - sum(
        j.end - j.start for j in jvps[:2])
    assert 0 <= own[fin.id] < fin.end - fin.start


def test_render_server_frames_spans_and_stale(ring, monkeypatch):
    rs = server.RenderServer(viewer.ViewerState(steps=20, device="cpu"),
                             width=16, height=8)
    real = animate.tier_frame
    calls = []

    def tier_frame(*args):
        calls.append(1)
        if len(calls) == 2:  # a command lands while frame 2 renders
            assert rs.apply("az =30") == "changed"
        return real(*args)

    monkeypatch.setattr(animate, "tier_frame", tier_frame)
    th = threading.Thread(target=rs.render_loop, kwargs={"max_frames": 4})
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and rs.error is None
    timings = rs.frame_timings()
    assert [t["seq"] for t in timings] == [1, 2, 3, 4]
    assert [t["stale"] for t in timings] == [False, True, False, False]
    assert all(t["lock_ms"] >= 0.0 and "trace_ms" in t for t in timings)
    records = profiling.spans()
    frames = [r for r in records if r.name == "frame"]
    assert [f.key for f in frames] == [1, 2, 3, 4]
    for f, t in zip(frames, timings):
        kids = [r for r in records if r.parent == f.id]
        assert [k.name for k in kids] == [
            "frame.lock", "frame.trace", "frame.readback", "frame.encode",
            "frame.lock"]
        assert all(f.start <= k.start <= k.end <= f.end for k in kids)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert all(k.thread == f.thread != threading.get_ident()
                   for k in kids)
        lock = sum(k.end - k.start for k in kids if k.name == "frame.lock")
        assert t["lock_ms"] == pytest.approx(lock / 1e6, abs=1e-9)
        # The stage's span, recorded when the stage ended, holds the
        # tier's render_image.
        (trace_stage,) = [k for k in kids if k.name == "frame.trace"]
        assert [r.name for r in records if r.parent == trace_stage.id] == [
            "image.render"]


def test_trace_writes_every_threads_spans_on_its_clock(ring, tmp_path):
    def work():
        with profiling.span("worker", 3):
            torch.ones(8).cumsum(0)

    with profiling.trace() as tr:
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
    assert tr.path.endswith("trace.json") and tr.profiler is not None
    events = json.loads(open(tr.path).read())["traceEvents"]
    (anchor,) = [e for e in events if e.get("name") == "profiling.trace"]
    (worker,) = [e for e in events if e.get("name") == "worker"]
    assert worker["cat"] == "span" and worker["args"] == {"key": "3"}
    assert anchor["ts"] <= worker["ts"]
    assert worker["ts"] + worker["dur"] <= anchor["ts"] + anchor["dur"]
    with profiling.trace(str(tmp_path)) as tr2:
        pass
    assert tr2.path == str(tmp_path / "trace.json")
