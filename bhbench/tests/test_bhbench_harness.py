"""The harness end to end on tiny CPU cells: the result line, the traced
breakdown, the refusals."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from bhbench import harness
from bhbench.drivers import drag
from bhbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_untraced_run_prints_the_contract_line(tmp_path, cell):
    rc, res, err = tiny.run(tmp_path, cell,
                            seconds=3.0 if cell.startswith("viewer") else 1.0)
    assert rc == 0
    assert list(res) == KEYS
    assert res["correct"] is True and res["attempted"] >= 1, (res, err)
    bench = harness.manifest()
    want = {m["name"] for m in bench["end_to_end"]
            if harness.applies(m, cell)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}"
                                               for n in res["checks"]]


def test_traced_run_reads_the_per_layer_metrics(tmp_path):
    rc, res, _ = tiny.run(tmp_path, "bench_fwd_rk4", seconds=1.0, trace=1)
    assert rc == 0
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    names = set(res["metrics"])
    assert "host_stage_ms.fwd" in names
    # No card: no kernel time, so no roofline share is made up.
    assert "k1_roofline_share.fwd" not in names


def test_no_card_means_no_result(tmp_path):
    bench, tdir = tiny.setup(tmp_path, "bench_fwd_rk4")
    import io

    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(["--workload", "bench_fwd_rk4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         device="cpu", require_card=True, bench=bench,
                         traffic_dir=tdir, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_jax_in_the_process_means_no_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = tiny.run(tmp_path, "bench_fwd_rk4", seconds=0.3)
    assert rc != 0 and res is None and "jax" in err


def test_forbidden_names_are_compared_whole(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "blackhole_tpu_torch.render",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "blackhole_tpu.render",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["blackhole_tpu"]


def test_a_bare_checkout_of_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bhbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "bhbench/run.py", "--workload",
                        "bench_fwd_rk4", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bench = harness.manifest()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell, cfg, traffic = harness.cell_of(bench, w["name"])
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
        assert set(traffic["limits"]) and cfg["reduced"] == []


def test_drag_schedule_is_fixed_by_the_seed():
    traffic = json.loads((tiny.TRAFFIC / "drag.json").read_text())

    def plan(seed):
        return drag.schedule(seed, 30.0, traffic, 0.0, 18.0)

    a = plan(7)
    assert a == plan(7) != plan(8)
    # Every seed sends as many commands: 12 drags of 6 throttled pairs
    # and the release's pair.
    assert {len(plan(s)) for s in (7, 8, 2**31 + 11)} == {168}
    assert all(0.0 <= t < 30.0 for t, _ in a)
    # The page's pairs: an absolute az, then el, at one due time.
    pairs = list(zip(a[::2], a[1::2]))
    assert all(x[0] == y[0] and x[1].startswith("az =")
               and y[1].startswith("el =") for x, y in pairs)
    cycle = traffic["drag_s"] + traffic["rest_s"]
    for d in range(12):
        ts = [p[0][0] for p in pairs if int(p[0][0] // cycle) == d]
        assert len(ts) == 7
        assert all(b - a >= traffic["throttle_s"]
                   for a, b in zip(ts[:6], ts[1:6]))
