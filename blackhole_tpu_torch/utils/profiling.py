"""Profiling: host spans, their place on a device trace, stages.

PyTorch counterpart of blackhole_tpu.utils.profiling, grown for the
port:

* span(name, key): a host span.  Each span that closes appends one
  Record to a process-wide ring of the newest CAPACITY records; dropped()
  counts the older ones.  Recording is always on and costs about a
  microsecond, most of it the interpreter's own with-block on a class.
  On a thread that torch.profiler records, the span is
  also a record_function, so the Chrome trace nests it over its ops;
  other threads skip that call (the profiler would not record it).
* place(spans, kernels, annotations): the offset from the spans' clock
  (time.perf_counter_ns) to a Chrome trace's, from the kernel launches
  that kernel.k1 / kernel.k2 spans enclose and from the spans the trace
  holds as annotations.
* trace(): torch.profiler over a block, exported as a Chrome trace with
  every thread's spans added on the trace's clock.
* Stages: CUDA events between the stages of one loop iteration (the
  render server's per-frame split), each stage also a host span.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
import types
from typing import NamedTuple

import numpy as np
import torch

CAPACITY = 65536  # records the ring keeps

# (span name, a substring of the kernel's name in a trace) of the spans
# around each launch of K1 and K2 (render/trace_kernel.py).
LAUNCHES = (("kernel.k1", "trace_kernel"), ("kernel.k2", "fwdgrad_kernel"))
# How far (us) a kernel may seem to start before its launch span when
# place checks the launches against the annotations: the trace's own
# error in putting the card's clock on the host's.
AGREE_US = 100.0


class Record(NamedTuple):
    """One closed span; start and end on time.perf_counter_ns()."""

    name: str
    key: object
    parent: int | None  # id of the enclosing span on the same thread
    thread: int  # threading.get_ident() of the thread that ran it
    start: int
    end: int
    id: int  # the span's place in closing order since the last clear()
    traced: bool  # also a record_function event of a running profiler


# The ring: (name, key, thread, start, end, traced) per closed span, in
# closing order.  Appends take no lock (list.append is atomic); a list
# twice the capacity long is cut back to the capacity under _lock.
_ring = []
_lock = threading.Lock()
_cut = 0  # records cut from the ring since the last clear()
_now = time.perf_counter_ns
_ident = threading.get_ident
_profiled = torch._C._autograd._profiler_enabled  # on this thread
# torch's Python flag of a running profiler, read before that C call
# (which costs more); a torch without the flag makes the call each time.
_running = (torch.autograd.profiler
            if hasattr(torch.autograd.profiler, "_is_profiler_enabled")
            else types.SimpleNamespace(_is_profiler_enabled=True))
_LIMIT = 2 * CAPACITY  # the ring's length that makes it cut back


def _cut_back() -> None:
    global _cut
    with _lock:
        n = len(_ring) - CAPACITY
        if n > 0:
            del _ring[:n]
            _cut += n


def spans() -> list:
    """The ring's records, oldest closed first (a copy).  A span's parent
    is the innermost span of its thread whose interval holds it, found
    here rather than when it ran, so that recording stays cheap; a span
    still open when this is called is nobody's parent yet."""
    with _lock:
        raw = _ring[-CAPACITY:]
        first = _cut + len(_ring) - len(raw)
    parent = [None] * len(raw)
    by_thread = collections.defaultdict(list)
    for i, r in enumerate(raw):
        by_thread[r[2]].append(i)
    for idx in by_thread.values():
        # Outer before inner: by start, then the later end, then the
        # later closing (a stage span recorded after the spans in it).
        idx.sort(key=lambda i: (raw[i][3], -raw[i][4], -i))
        stack = []
        for i in idx:
            start, end = raw[i][3], raw[i][4]
            while stack and not (start < raw[stack[-1]][4]
                                 and end <= raw[stack[-1]][4]):
                stack.pop()
            if stack:
                parent[i] = first + stack[-1]
            stack.append(i)
    return [Record(n, k, parent[i], t, s, e, first + i, tr)
            for i, (n, k, t, s, e, tr) in enumerate(raw)]


def dropped() -> int:
    """Records the ring has let go since the last clear()."""
    with _lock:
        return _cut + max(0, len(_ring) - CAPACITY)


def clear() -> None:
    """Empty the ring."""
    global _cut
    with _lock:
        _ring.clear()
        _cut = 0


class span:
    """Host span: `with span(name, key) as s:` appends a record to the
    ring when the block ends, whether it returns or raises.  s.key may
    be set inside the block (a frame learns its seq at publication)."""

    __slots__ = ("name", "key", "start", "end", "_rf")

    def __init__(self, name: str, key=None):
        self.name = name
        self.key = key

    def __enter__(self, _now=_now, _running=_running, _profiled=_profiled):
        self.start = _now()
        if _running._is_profiler_enabled and _profiled():
            self._rf = rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, et, ev, tb, _now=_now, _ident=_ident, _ring=_ring,
                 _len=len):
        rf = self._rf
        if rf is not None:
            rf.__exit__(None, None, None)
        self.end = end = _now()
        _ring.append((self.name, self.key, _ident(), self.start, end,
                      rf is not None))
        if _len(_ring) > _LIMIT:
            _cut_back()
        return False

    @property
    def ns(self) -> int:
        """The closed span's length."""
        return self.end - self.start


def self_ns(records) -> dict:
    """{id: the span's length less the part its child spans cover} over
    records (children on one thread run one after another)."""
    out = {r.id: r.end - r.start for r in records}
    for r in records:
        if r.parent in out:
            out[r.parent] -= r.end - r.start
    return out


# ---- the device trace's clock ------------------------------------------
def place(spans, kernels, annotations=()):
    """Offset (us) from the spans' clock to a Chrome trace's: a span
    point t (perf_counter_ns) sits at t / 1e3 + offset on the trace.

    kernels and annotations: (name, start, end) events of the trace, in
    its microseconds.  Launch anchors: the LAUNCHES spans, in order,
    against the trace's kernels of the same family, a contiguous run of
    them (the trace covers part of the spans) aligned where the
    differences of consecutive (kernel start - span start) are least.  A
    kernel cannot start before its launch span does, so the least
    (kernel start - span start) of the pairs bounds the offset from
    above, within the work the span does before the launch plus the
    launch's latency.  Annotation anchors: spans that entered
    record_function (Record.traced) against the trace's events of their
    name, in order; each event lies inside its span, which bounds the
    offset from both sides.  With both, the annotations give the offset
    where no kernel then starts more than AGREE_US before its launch
    span.  None where nothing anchors the clock or the anchors
    disagree; a family of launches whose alignment is ambiguous anchors
    nothing."""
    spans = list(spans)
    ann = _annotation_offset(spans, annotations)
    launch = _launch_offset(spans, kernels, ann)
    if ann is None or launch is None:
        return launch if ann is None else ann
    return ann if launch >= ann - AGREE_US else None


def _annotation_offset(spans, annotations):
    traced = collections.defaultdict(list)
    for r in spans:
        if r.traced:
            traced[r.name].append(r)
    events = collections.defaultdict(list)
    for name, s, e in annotations:
        if name in traced:
            events[name].append((s, e))
    lo, hi = -np.inf, np.inf
    for name, evs in events.items():
        for r, (s, e) in zip(sorted(traced[name], key=lambda r: r.start),
                             sorted(evs)):
            lo = max(lo, e - r.end / 1e3)
            hi = min(hi, s - r.start / 1e3)
    if hi == np.inf or lo > hi + 1.0:  # 1 us: the trace's rounding
        return None
    return 0.5 * (lo + hi)


def _launch_offset(spans, kernels, prior):
    """The least of the families' upper bounds (of those with a clear
    alignment), or None."""
    kernels = list(kernels)
    bounds = []
    for span_name, kernel_name in LAUNCHES:
        k = np.array(sorted(s for n, s, _ in kernels if kernel_name in n))
        s = np.array(sorted(r.start for r in spans if r.name == span_name),
                     dtype=np.float64) / 1e3
        if not k.size:
            continue
        if s.size < k.size:
            return None
        d = k[None, :] - np.lib.stride_tricks.sliding_window_view(s, k.size)
        bound = d.min(axis=1)
        if k.size >= 3:
            # The right alignment leaves the changes of the launches'
            # latencies (and of a clock's slow drift); a wrong one, the
            # differences of the intervals between launches.
            score = np.median(np.abs(np.diff(d, axis=1)), axis=1)
            order = np.argsort(score)
            j = int(order[0])
            if order.size > 1 and score[order[1]] <= 4.0 * score[j]:
                continue  # ambiguous
        elif prior is not None:
            # Too few to align alone: the tightest bound the annotations
            # allow.
            fits = np.nonzero(bound >= prior - AGREE_US)[0]
            if not fits.size:
                continue
            j = int(fits[np.argmin(bound[fits])])
        else:
            continue
        bounds.append(float(bound[j]))
    return min(bounds) if bounds else None


class Trace:
    """What trace() yields: the profiler, and the path its Chrome trace
    is written to when the block ends."""

    def __init__(self, profiler, path: str):
        self.profiler = profiler
        self.path = path


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with torch.profiler (the card's kernels too
    when CUDA is available) and write its Chrome trace to
    log_dir/trace.json (default: a new temporary directory), with the
    spans that every thread closed in the block added as events
    (category "span") on the trace's clock.  Yields a Trace."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="blackhole_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Trace(None, os.path.join(log_dir, "trace.json"))
    t0 = _now()
    with torch.profiler.profile(activities=activities) as prof:
        out.profiler = prof
        with span("profiling.trace"):  # an anchor for place
            yield out
            synchronize()
    t1 = _now()
    prof.export_chrome_trace(out.path)
    _add_spans(out.path, [r for r in spans() if r.start >= t0
                          and r.end <= t1])


def _add_spans(path: str, records) -> None:
    """Add the records that the trace lacks to the Chrome trace at path,
    placed on its clock (nothing when place finds no offset)."""
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]

    def of(cat):
        return [(e.get("name", ""), float(e["ts"]),
                 float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in events if e.get("cat") == cat]

    off = place(records, of("kernel"), of("user_annotation"))
    if off is None:
        return
    native = {t.ident: t.native_id for t in threading.enumerate()}
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": r.name, "pid": pid,
         "tid": native.get(r.thread, r.thread),
         "ts": r.start / 1e3 + off, "dur": (r.end - r.start) / 1e3,
         "args": {"key": repr(r.key)}}
        for r in records if not r.traced)
    with open(path, "w") as f:
        json.dump(doc, f)


def synchronize() -> None:
    """Wait for every queued CUDA operation of the process (nothing to
    wait for when CUDA was never used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stages:
    """Times consecutive stages of one loop iteration on a device: mark
    records a CUDA event on the card (read by ms() once the iteration
    has synchronised) and the host clock elsewhere.  The first mark,
    "start", is taken at construction.  Each later mark also records
    the host span <prefix>.<stage> over the host's time since the
    previous mark (the spans run in the stage are its children); with
    prefix None it records none (the caller spans its stages itself)."""

    def __init__(self, device, prefix: str | None = "frame"):
        self._cuda = torch.device(device).type == "cuda"
        self._prefix = prefix
        self._marks = []
        self._host = _now()
        self.mark("start")

    def mark(self, name: str) -> None:
        if self._cuda:
            point = torch.cuda.Event(enable_timing=True)
            point.record()
        else:
            point = time.perf_counter()
        if self._marks and self._prefix is not None:
            now = _now()
            _ring.append((f"{self._prefix}.{name}", None, _ident(),
                          self._host, now, False))
            if len(_ring) > _LIMIT:
                _cut_back()
            self._host = now
        self._marks.append((name, point))

    def ms(self) -> dict:
        """{f"{stage}_ms": ms from the previous mark to the stage's}."""
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[f"{name}_ms"] = (a.elapsed_time(b) if self._cuda
                                 else (b - a) * 1e3)
        return out
