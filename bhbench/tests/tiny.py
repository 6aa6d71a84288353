"""Tiny CPU versions of the benchmark's cells for its own tests: the
real traffic files and limits, at sizes a CPU test run holds."""

from __future__ import annotations

import io
import json
from pathlib import Path

import torch

from bhbench import harness

# One intra-op thread: the tests share the machine with other workers.
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
TRAFFIC = harness.HERE / "traffic"

# cell -> (tiny configuration, traffic of the real cell, overrides)
CELLS = {
    "bench_fwdbwd_rk4": ("tiny_bench", "fit_mass_spin",
                         {"draws": 64, "check_steps": 1,
                          "trace_seconds": 0.2}),
    "bench_fwd_rk4": ("tiny_bench", "orbit_frames",
                      {"draws": 64, "check_frames": 1,
                       "trace_seconds": 0.2}),
    "viewer_drag": ("tiny_viewer", "drag",
                    {"check_frames": 3, "check_pixels": 64,
                     "trace_seconds": 0.5}),
    "viewer_drag_particles": ("tiny_viewer", "drag_particles",
                              {"check_frames": 3, "check_pixels": 64,
                               "trace_seconds": 0.5,
                               "viewer_state": {"particles": True,
                                                "n_particles": 300}}),
}


def setup(tmp_path: Path, cell: str):
    """(manifest, traffic directory) of the real BENCHMARK.json with the
    cell on its tiny configuration."""
    bench = harness.manifest()
    cfg, traffic, over = CELLS[cell]
    t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
    t.update(over)
    (tmp_path / f"{traffic}.json").write_text(json.dumps(t))
    bench["configs"].append({"name": cfg, "source": "test",
                             "file": f"bhbench/tests/data/{cfg}.json",
                             "reduced": [], "why": "test"})
    for w in bench["workloads"]:
        if w["name"] == cell:
            w["config"] = cfg
    return bench, tmp_path


def run(tmp_path: Path, cell: str, seconds=0.5, trace=0, seed=3000000019):
    """(exit code, last stdout line as JSON or None, stderr text) of one
    run of a tiny cell on the CPU."""
    bench, tdir = setup(tmp_path, cell)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         device="cpu", require_card=False, bench=bench,
                         traffic_dir=tdir, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def cell_after_window(tmp_path: Path, cell: str, seconds=0.5,
                      seed=3000000019):
    """A tiny cell's driver object once its window has closed (for the
    control and the fault tests)."""
    import importlib
    import time

    import torch

    bench, tdir = setup(tmp_path, cell)
    entry, config, traffic = harness.cell_of(bench, cell, tdir)
    r = harness.Run(cell, config, traffic, seed, seconds, False,
                    torch.device("cpu"), time.time())
    driver = importlib.import_module("bhbench.drivers." + traffic["driver"])
    c = driver.Cell(r)
    c.window()
    return c
