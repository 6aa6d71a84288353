"""The benchmark harness: one run of one cell of BENCHMARK.json.

    python3 bhbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is data: BENCHMARK.json names its configuration
(a file under bhbench/configs/) and its traffic (bhbench/traffic/<name>.json,
whose "driver" names the module of bhbench/drivers/ that runs that kind
of traffic); each per-layer metric is read by bhbench/metrics/<name>.py.
A driver sets the cell up from the seed, measures for --seconds, and
then checks what the timed path produced against the plain reference
(bhbench/reference/).  The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the numbers compared with their limits, which also
end standard error.

A run needs a CUDA card and exits non-zero without a result when there
is none, when the program cannot be imported, or when JAX or the JAX
package was loaded in the process.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blackhole_tpu")


def process_start_epoch() -> float:
    """time.time() at which this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (blackhole_tpu_torch is not blackhole_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Fail(Exception):
    """A run that cannot produce a result."""


class Run:
    """One run of one cell: its inputs, and what the driver gathers for
    the end-to-end metrics, the per-layer readers and the check."""

    def __init__(self, cell, config, traffic, seed, seconds, traced, device,
                 started):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(traced)
        self.device = device
        self.started = started  # time.time() at process start
        self.window_open = None  # time.time() at the window's start
        self.e2e = {}
        self.attempted = 0
        self.failed = 0
        self.checks = []  # (name, value, limit)
        self.memory_peak = 0
        self.trace = None  # devtrace.DeviceTrace of the traced window
        self.data = {}  # per-driver values the metric readers read
        self._tracer = None

    # ---- timing --------------------------------------------------------
    def open_window(self):
        """The first measured piece of work starts now: set-up ends."""
        self.window_open = time.time()

    @property
    def setup_s(self) -> float:
        return self.window_open - self.started

    @contextlib.contextmanager
    def span(self, name: str):
        """Under a traced window, a profiler annotation around a call
        into the program (the breakdown names idle gaps by it)."""
        if self.tracing:
            import torch

            with torch.profiler.record_function("bhbench." + name):
                yield
        else:
            yield

    def start_trace(self):
        if not self.traced or self._tracer is not None or self.trace:
            return False
        from bhbench import devtrace

        self._tracer = devtrace.Tracer()
        self._tracer.start()
        return True

    def stop_trace(self):
        """Close the traced window; its trace is read by read_trace."""
        if self._tracer is not None:
            self._tracer.stop()

    def read_trace(self):
        if self._tracer is not None:
            self.trace = self._tracer.read()
            self._tracer = None

    @property
    def tracing(self) -> bool:
        return self._tracer is not None and not self._tracer.stopped

    def closed_loop(self, work, limit: int, trace_seconds: float):
        """One caller's closed loop: work(i) for i = 0, 1, ... back to
        back until the window's seconds have passed (at most `limit`
        calls); under --trace 1 the profiler covers the first
        trace_seconds.  The window ends in a synchronise.  Returns (the
        results, the window's seconds); sets data["traced_items"] and
        data["wall_per_item_s"], an item's wall time outside the traced
        part, which the profiler's host-side recording slows."""
        outs = []
        self.sync()
        self.open_window()
        t0 = time.perf_counter()
        self.start_trace()
        t_resume = None
        while len(outs) < limit:
            now = time.perf_counter()
            if now - t0 >= self.seconds:
                break
            if self.tracing and now - t0 >= trace_seconds:
                self.stop_trace()
                self.data["traced_items"] = len(outs)
                t_resume = time.perf_counter()
            outs.append(work(len(outs)))
        self.sync()
        t1 = time.perf_counter()
        if self.tracing:
            self.stop_trace()
            self.data["traced_items"] = len(outs)
        done = len(outs) - self.data.get("traced_items", 0)
        if t_resume is not None and done > 0:
            self.data["wall_per_item_s"] = (t1 - t_resume) / done
        else:
            self.data["wall_per_item_s"] = (t1 - t0) / max(len(outs), 1)
        if self.device.type == "cuda":
            import torch

            self.memory_peak = torch.cuda.max_memory_allocated()
        self.attempted = len(outs)
        return outs, t1 - t0

    def check(self, name: str, value: float, limit: float):
        self.checks.append((name, float(value), float(limit)))

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str, traffic_dir: Path = HERE / "traffic"):
    """(cell entry, config dict, traffic dict) of a workload name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(Path(traffic_dir) / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def applies(metric: dict, cell: str, reported=None) -> bool:
    """Whether a metric is reported in a cell: listed there, or with no
    list, reported wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if reported is not None:
        return metric.get("moves") in reported
    return True


def reader(name: str):
    """The read(run) function of bhbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bhbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_record(run: Run, chips: int) -> dict:
    import torch

    if run.device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": int(run.memory_peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": chips,
               "memory_peak_bytes": int(run.memory_peak)}
    if run.trace is not None:
        rec["busy_s"] = run.trace.busy_s()
        rec["window_s"] = run.trace.window_s
    return rec


def execute(argv, device: str = "cuda", require_card: bool = True,
            bench=None, traffic_dir=None, out=None, err=None) -> int:
    """Run one cell; returns the exit code.  device, require_card, bench
    (a manifest in place of BENCHMARK.json) and traffic_dir are for the
    harness's own tests on the CPU: a benchmark run always asks for the
    card."""
    out = out or sys.stdout
    err = err or sys.stderr
    started = process_start_epoch()
    ap = argparse.ArgumentParser(prog="bhbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = bench or manifest()
        cell, config, traffic = cell_of(bench, args.workload,
                                        traffic_dir or HERE / "traffic")
        import torch

        if require_card:
            if not torch.cuda.is_available():
                raise Fail("no CUDA device: this benchmark measures the card")
            if torch.cuda.device_count() < int(cell["chips"]):
                raise Fail(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        dev = torch.device(device)
        run = Run(cell["name"], config, traffic, args.seed, args.seconds,
                  args.trace, dev, started)
        driver = importlib.import_module("bhbench.drivers."
                                         + traffic["driver"])
        driver.run(run)
        run.read_trace()
        driver.check(run)
    except Fail as exc:
        print(f"bhbench: {exc}", file=err)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"bhbench: the run loaded {', '.join(bad)}; the benchmark "
              "measures the PyTorch port alone", file=err)
        return 3

    e2e = [m for m in bench["end_to_end"] if applies(m, run.cell)]
    metrics = {}
    if not args.trace:
        for m in e2e:
            v = run.setup_s if m["name"] == "setup_s" else run.e2e.get(
                m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        reported = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if applies(m, run.cell, reported):
                v = reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in run.checks) and bool(run.checks)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_record(run, int(cell["chips"]))}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    for n, v, lim in run.checks:
        print(f"check {n}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main() -> int:
    return execute(sys.argv[1:])
