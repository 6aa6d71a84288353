"""The sharded cell bench_fwdbwd_rk4_x4 on a tiny CPU version: the bench
scene of tiny_bench over 2 gloo ranks (tiny_bench_x2), with the cell's
own traffic and limits.  The contract line, the traced run's per-layer
metrics, rank 0's share broken where it is produced, a spawned rank
whose share of the gradient is zeroed, a spawned rank that raises, and
the control.

A spawned rank runs the main script of its process again (as
__mp_main__) before its job, so the faults of spawned ranks are put in
a script that patches the program at import and runs the harness under
its main guard, in a subprocess of its own."""

import json
import os
import subprocess
import sys
import textwrap
import time
import uuid
from unittest import mock

import pytest
import torch

from bhbench import harness
from bhbench.tests import test_bhbench_faults, tiny

CELL = "bench_fwdbwd_rk4_x4"
# tiny.CELLS's entry for the cell: tiny configuration, traffic, overrides.
TINY = {CELL: ("tiny_bench_x2", "fit_mass_spin_x4",
               {"draws": 64, "check_steps": 1, "trace_seconds": 0.2})}
SHARDING = {"rank_imbalance.fwdbwd_x4", "allreduce_ms.fwdbwd_x4",
            "device_idle_share.fwdbwd_x4"}


def run(tmp_path, seconds, trace=0):
    with mock.patch.dict(tiny.CELLS, TINY):
        return tiny.run(tmp_path, CELL, seconds=seconds, trace=trace)


def test_untraced_run_prints_the_contract_line(tmp_path):
    rc, res, err = run(tmp_path, 1.0)
    assert rc == 0, err
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1, (res, err)
    assert set(res["metrics"]) == {"grad_rays_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_run_reads_the_sharding_metrics(tmp_path, capsys):
    # A CPU step takes seconds: the first step of the window is traced,
    # the next ones are the untraced steps the sharding metrics read.
    rc, res, err = run(tmp_path, 25.0, trace=1)
    assert rc == 0, err
    assert res["correct"] is True, (res["checks"], err)
    assert res["attempted"] >= 2
    assert SHARDING <= set(res["metrics"]), res["metrics"]
    assert res["metrics"]["rank_imbalance.fwdbwd_x4"]["value"] >= 0.0
    assert res["metrics"]["allreduce_ms.fwdbwd_x4"]["value"] >= 0.0
    # No card: no kernel time, so no roofline share is made up.
    assert "k2_roofline_share.fwdbwd_x4" not in res["metrics"]
    printed = capsys.readouterr().err  # sharded_grad_loop's rank line
    ranks = json.loads(printed.split("bhbench: ranks ", 1)[1]
                       .splitlines()[0])
    assert [r["rank"] for r in ranks] == [0, 1]
    # One all_reduce of 12 bytes a step, warm-up included; rank 0's
    # counters are its process's (earlier runs in it count too).
    calls = res["attempted"] + 1
    assert ranks[1]["collectives"] == calls, ranks
    assert all(r["collectives"] >= calls and r["collective_bytes"]
               == 12 * r["collectives"] and not r["forbidden"]
               for r in ranks), ranks


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_rank_0s_broken_share_is_not_correct(tmp_path, monkeypatch,
                                                fault):
    """test_bhbench_faults' gradient faults in rank 0, the harness's own
    process: its share of the all-reduced sum is wrong."""
    test_bhbench_faults._grad_fault(monkeypatch, fault)
    rc, res, err = run(tmp_path, 1.0)
    assert rc == 0, err
    assert res["correct"] is False, (res["checks"], err)


def test_the_control_fails_a_limit(tmp_path):
    with mock.patch.dict(tiny.CELLS, TINY):
        c = tiny.cell_after_window(tmp_path, CELL)
    try:
        got = c.control(torch.bfloat16)
    finally:
        c.close()
    lim = c.r.traffic["limits"]
    assert any(v > lim[n] for n, v in got.items()), (got, lim)


SCRIPT = """
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, {root!r})

import torch
import torch.distributed as dist

from blackhole_tpu_torch.grad import fast_grad

FAULT = os.environ["BHBENCH_TEST_FAULT"]
_real = fast_grad.scene_value_and_grad


def _broken(*args, **kw):
    vg = _real(*args, **kw)
    calls = []

    def call(params, o, d, order=None):
        loss, g = vg(params, o, d, order)
        calls.append(1)
        if dist.is_initialized() and dist.get_rank() == 1:
            if FAULT == "raise" and len(calls) == 2:
                raise RuntimeError("rank 1 fails on purpose")
            if FAULT == "zero":
                g = {{k: torch.zeros_like(v) for k, v in g.items()}}
        return loss, g

    return call


fast_grad.scene_value_and_grad = _broken

if __name__ == "__main__":
    from bhbench.tests import test_bhbench_sharded

    rc, res, err = test_bhbench_sharded.run(Path(sys.argv[1]), 1.0)
    print(json.dumps({{"rc": rc, "res": res}}))
"""


def _run_script(tmp_path, fault, timeout):
    """(completed process, seconds, token) of the tiny cell run with a
    fault in rank 1; the token marks every process of the run."""
    script = tmp_path / "fault_run.py"
    script.write_text(textwrap.dedent(SCRIPT.format(root=str(harness.ROOT))))
    token = uuid.uuid4().hex
    env = dict(os.environ, BHBENCH_TEST_FAULT=fault,
               BHBENCH_TEST_TOKEN=token)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)
    return proc, time.perf_counter() - t0, token


def _marked(token):
    """The live processes whose environment holds the token."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if token.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            continue
    return found


def _none_left(token, wait_s=10.0):
    t0 = time.monotonic()
    while _marked(token) and time.monotonic() - t0 < wait_s:
        time.sleep(0.2)
    return _marked(token)


def test_a_rank_that_zeroes_its_gradient_share_is_not_correct(tmp_path):
    proc, _, token = _run_script(tmp_path, "zero", timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert out["res"]["correct"] is False, out["res"]["checks"]
    assert out["res"]["checks"]["loss_rel_gap"]["value"] <= \
        out["res"]["checks"]["loss_rel_gap"]["limit"]
    assert not _none_left(token)


def test_a_rank_that_raises_ends_the_run_without_leaving_a_process(
        tmp_path):
    proc, seconds, token = _run_script(tmp_path, "raise", timeout=300)
    assert proc.returncode != 0
    assert "rank 1 fails on purpose" in proc.stderr, proc.stderr[-3000:]
    assert seconds < 120
    assert not _none_left(token)
