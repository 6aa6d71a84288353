"""The traced window: torch.profiler over part of a run, read back from
its Chrome trace into device activity, kernel times and host spans.

The profiler records host operations and, through CUPTI, every kernel,
copy and fill on the card.  The trace file goes to a directory made
under TMPDIR and is deleted once read.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

from bhbench import arith

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bhbench.window"


class DeviceTrace:
    """What one traced window read: kernels (name, start, end), device
    activity intervals, host events, and the window, in seconds on the
    trace's clock."""

    def __init__(self, events):
        self.kernels = []
        self.busy = []
        host = []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e.get("ts", 0.0)) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            if cat in _DEVICE_CATS:
                self.busy.append((t0, t1))
                if cat == "kernel":
                    self.kernels.append((e.get("name", "?"), t0, t1))
            elif cat in _HOST_CATS:
                if e.get("name") == WINDOW and cat == "user_annotation":
                    self.window = (t0, t1)
                host.append((e.get("name", "?"), t0, t1))
        if self.window is None:
            raise RuntimeError("the traced window's annotation is missing")
        self.host = host

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in the window in which something ran on the card."""
        w0, w1 = self.window
        return arith.union_seconds(
            [(max(s, w0), min(e, w1)) for s, e in self.busy
             if e > w0 and s < w1])

    def kernel_seconds(self, match) -> float:
        """Device seconds of the window's kernels whose name satisfies
        match(name)."""
        w0, w1 = self.window
        return sum(min(e, w1) - max(s, w0) for n, s, e in self.kernels
                   if match(n) and e > w0 and s < w1)

    def device_ops(self, top: int = 10):
        """[[kernel name, seconds]] of the kernels that took most time."""
        acc = {}
        for n, s, e in self.kernels:
            acc[n] = acc.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10, longest: int = 400):
        """[[what the host was doing, idle seconds]]: the `longest` idle
        gaps of the card, each named by the innermost host operation or
        span over its middle (and the harness span around it), summed by
        name."""
        gaps = arith.idle_gaps(self.busy, *self.window)
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:longest]
        if not gaps:
            return []
        names = [h[0] for h in self.host if h[0] != WINDOW]
        starts = np.array([h[1] for h in self.host if h[0] != WINDOW])
        ends = np.array([h[2] for h in self.host if h[0] != WINDOW])
        spans = [i for i, n in enumerate(names) if n.startswith("bhbench.")]
        acc = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label = "no host operation"
            if len(names):
                inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
                if inside.size:
                    inner = inside[np.argmin(ends[inside] - starts[inside])]
                    label = names[inner]
                    outer = [i for i in spans if starts[i] <= mid <= ends[i]]
                    if outer and names[outer[-1]] != label:
                        label = f"{names[outer[-1]]} > {label}"
            acc[label] = acc.get(label, 0.0) + (g1 - g0)
        return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]


def loop_idle_share(run):
    """The card's idle share in a closed loop, in %: 1 - (its busy time
    per step or frame in the traced part of the window: the union of
    its kernels, copies and fills) / (a step's or frame's wall time in
    the untraced part, which the profiler's host-side recording does not
    slow).  None where the run traced nothing."""
    items = run.data.get("traced_items")
    wall = run.data.get("wall_per_item_s")
    if run.trace is None or not items or not wall:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / items / wall)


def loop_host_ms(run, match):
    """Mean milliseconds of a closed loop's step or frame outside the
    kernels whose name satisfies match(name): its wall time (host clock,
    in the untraced part of the window) less those kernels' device time
    per step or frame in the traced part.  None where the run traced
    nothing."""
    items = run.data.get("traced_items")
    wall = run.data.get("wall_per_item_s")
    if run.trace is None or not items or not wall:
        return None
    return 1e3 * (wall - run.trace.kernel_seconds(match) / items)


class Tracer:
    """torch.profiler started and stopped around part of a window; the
    trace is read once the window has closed."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self._mark = None
        self.stopped = False

    def start(self):
        torch = self._torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self):
        """Close the traced window once the card has finished its work."""
        if self.stopped:
            return
        if self._torch.cuda.is_initialized():
            self._torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.stopped = True

    def read(self) -> DeviceTrace:
        """Export the trace, read it and delete its file."""
        self.stop()
        out = tempfile.mkdtemp(prefix="bhbench_trace_")
        try:
            path = os.path.join(out, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(out, ignore_errors=True)
        self._prof = None
        return DeviceTrace(events)
