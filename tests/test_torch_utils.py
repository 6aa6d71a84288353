"""The port's utilities: utils.profiling, utils.logging and
utils.checkpoint, as tests/test_utils_viz.py holds the JAX package's,
plus the checkpointed fit: fit_with_checkpointing at 8x8, 150 steps,
float64 (the JAX package's reverse-mode fit case, cut to 8x8), where 2
steps and a resume for 2 more equal inverse.fit's 4 steps in one go,
bit for bit."""

import dataclasses
import json
import logging
import os

import torch

from blackhole_tpu_torch.geom import types
from blackhole_tpu_torch.grad import inverse
from blackhole_tpu_torch.utils import checkpoint, profiling
from blackhole_tpu_torch.utils import logging as bh_logging

torch.set_num_threads(1)  # see tests/test_torch_step.py


def test_throttled_logger():
    lg = bh_logging.get_logger("blackhole_tpu_torch.test")
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture()
    lg.addHandler(handler)
    try:
        th = bh_logging.Throttled(lg, every=10)
        for _ in range(25):
            th.log(logging.INFO, "spam")
    finally:
        lg.removeHandler(handler)
    assert [r.getMessage() for r in records] == [
        "spam (call 1)", "spam (call 11)", "spam (call 21)"]


def test_stages_and_trace(tmp_path):
    """Stages on the CPU: one entry per mark after the first, in ms, and
    a host span frame.<stage> per stage; trace writes a Chrome trace
    holding the block's ops and the stages' spans, to log_dir or to a
    new temporary directory."""
    profiling.clear()
    with profiling.trace(str(tmp_path)) as tr:
        stages = profiling.Stages("cpu")
        torch.ones(64).cumsum(0)
        stages.mark("a")
        stages.mark("b")
    ms = stages.ms()
    assert list(ms) == ["a_ms", "b_ms"] and min(ms.values()) >= 0.0
    spans = [r for r in profiling.spans() if r.name.startswith("frame.")]
    assert [r.name for r in spans] == ["frame.a", "frame.b"]
    assert spans[0].end == spans[1].start
    assert tr.path == str(tmp_path / "trace.json")
    events = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name", "") for e in events["traceEvents"]]
    assert any("cumsum" in n for n in names)
    assert {"frame.a", "frame.b"} <= set(names)
    with profiling.trace() as tr:
        torch.ones(8).sum()
    assert os.path.isfile(tr.path) and tr.path.endswith("trace.json")
    assert os.path.dirname(tr.path) != str(tmp_path)
    profiling.clear()


def test_checkpoint_roundtrip(tmp_path):
    """save/restore, resume by latest, keep the newest max_to_keep, and
    (None, None) on an empty directory."""
    d = str(tmp_path / "ck")
    assert checkpoint.restore(d) == (None, None)
    for step in range(5):
        checkpoint.save(d, step, {"params": {"a": torch.arange(4.0) + step},
                                  "step": step}, max_to_keep=3)
    assert sorted(os.listdir(d)) == ["2", "3", "4"]
    step, state = checkpoint.restore(d)
    assert step == 4 and state["step"] == 4
    assert torch.equal(state["params"]["a"], torch.arange(4.0) + 4)
    step, state = checkpoint.restore(d, step=2)
    assert step == 2 and torch.equal(state["params"]["a"],
                                     torch.arange(4.0) + 2)
    checkpoint.save(d, 4, {"step": -1}, max_to_keep=3)  # saved again
    assert checkpoint.restore(d) == (4, {"step": -1})


def test_checkpoint_interrupted_save_keeps_old(tmp_path, monkeypatch):
    """A save that fails midway, of a new step or of a step saved again,
    leaves the checkpoints as they were and no temporary directory."""
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, {"step": 1})

    def broken(state, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken)
    for step in (1, 2):
        try:
            checkpoint.save(d, step, {"step": -1})
        except OSError:
            pass
        else:
            raise AssertionError("the broken save did not raise")
        assert checkpoint.restore(d) == (1, {"step": 1})
        assert sorted(os.listdir(d)) == ["1"]
        assert os.listdir(os.path.join(d, "1")) == ["state.pt"]


def _fit_case():
    """(target, start scene, camera) of the 8x8 float64 fit: Kerr a=0.5,
    150 steps, a seeded target, mass 1.15 to start."""
    dev = dict(device="cpu", dtype=torch.float64)
    scene = types.Scene(
        types.BlackHole.create(1.0, 0.5, **dev), types.Disk.create(**dev),
        types.SimConfig.create(time_step=0.1, max_ray_distance=60.0,
                               max_steps=150, **dev), True)
    camera = types.Camera.create(position=(0.0, -30.0, 8.0),
                                 direction=(0.0, 30.0, -8.0),
                                 up=(0.0, 0.0, 1.0), fov_deg=25.0, **dev)
    target = torch.rand((8, 8, 3), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
    start = dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=torch.tensor(1.15, dtype=torch.float64)))
    return target, start, camera


def test_fit_with_checkpointing_resumes_bit_for_bit(tmp_path):
    """2 steps, then a resume from the checkpoint for 2 more, equal
    inverse.fit's 4 steps in one go bit for bit: the losses (the first
    being inverse.fit's) and the fitted parameters."""
    target, start, camera = _fit_case()
    kw = dict(learning_rate=2e-2, optimize=("log_mass",))
    s4, _, l4 = inverse.fit(target, start, camera, 8, 8, steps=4, **kw)
    d = str(tmp_path / "ck")
    _, _, l2 = checkpoint.fit_with_checkpointing(
        target, start, camera, 8, 8, d, steps=2, save_every=2, **kw)
    assert sorted(os.listdir(d)) == ["1"]
    r4, _, lr = checkpoint.fit_with_checkpointing(
        target, start, camera, 8, 8, d, steps=4, save_every=2, **kw)
    assert sorted(os.listdir(d)) == ["1", "3"]
    assert len(l2) == 2 and len(lr) == 2
    assert l2 + lr == l4
    assert torch.equal(r4.blackhole.mass, s4.blackhole.mass)
    assert torch.equal(r4.blackhole.spin, s4.blackhole.spin)
    assert float(s4.blackhole.mass) != float(start.blackhole.mass)
