"""Profiling and throughput metrics.

PyTorch counterpart of blackhole_tpu.utils.profiling: a wall-clock
Timer that synchronises the card before it reads the clock, rays/s,
one-line JSON metrics, a torch.profiler trace exported as a Chrome
trace, and Stages, CUDA events between the stages of one loop
iteration (the render server's per-frame split).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch


def synchronize() -> None:
    """Wait for every queued CUDA operation of the process (nothing to
    wait for when CUDA was never used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class Timer:
    """Wall-clock timer whose spans end in a synchronise, so they cover
    the device's work and not only its enqueue."""

    name: str = "timer"
    samples: list = field(default_factory=list)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        yield
        synchronize()
        self.samples.append(time.perf_counter() - t0)

    def measure(self, fn, *args, warmup: int = 1, repeats: int = 3):
        """Best-of-N timing of fn(*args) after warmup untimed calls (the
        first builds or loads the kernels)."""
        out = fn(*args)
        synchronize()
        for _ in range(max(0, warmup - 1)):
            fn(*args)
            synchronize()
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(*args)
            synchronize()
            self.samples.append(time.perf_counter() - t0)
        return out

    @property
    def best(self):
        return min(self.samples) if self.samples else float("nan")

    @property
    def mean(self):
        return (
            sum(self.samples) / len(self.samples)
            if self.samples
            else float("nan")
        )


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with torch.profiler (the card's kernels too
    when CUDA is available) and write its Chrome trace to
    log_dir/trace.json (default: blackhole_tpu_torch_trace in the
    temporary directory).  Yields the profiler."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "blackhole_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def emit_metric(metric: str, value: float, unit: str, **extra) -> str:
    """One-line JSON metric record (the bench.py output contract)."""
    line = json.dumps(
        {"metric": metric, "value": value, "unit": unit, **extra}
    )
    print(line)
    return line


class Stages:
    """Times consecutive stages of one loop iteration on a device: mark
    records a CUDA event on the card (read by ms() once the iteration
    has synchronised) and the host clock elsewhere.  The first mark,
    "start", is taken at construction."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self._cuda:
            point = torch.cuda.Event(enable_timing=True)
            point.record()
        else:
            point = time.perf_counter()
        self._marks.append((name, point))

    def ms(self) -> dict:
        """{f"{stage}_ms": ms from the previous mark to the stage's}."""
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[f"{name}_ms"] = (a.elapsed_time(b) if self._cuda
                                 else (b - a) * 1e3)
        return out
