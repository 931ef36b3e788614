"""Tracing and per-step timing: the port of ``synthsr_tpu/utils/profiling.py``
(the reference has only a LoopInfo ETA printer).

- :func:`trace` records ``torch.profiler`` (the CPU, and the CUDA device when
  there is one) and writes a Chrome trace, viewable in Perfetto;
- :func:`annotate` is a named region in that trace
  (``torch.profiler.record_function``);
- :class:`StepTimer` keeps per-step wall-clock times, synchronising the CUDA
  device around each step when there is one, so a step's time includes its
  kernels; it appends each step to an optional jsonl log;
- :func:`device_memory_stats` returns ``torch.cuda.memory_stats`` per device;
- :func:`span` and :func:`count` are the program's own tracer: named host
  intervals and counters placed where the work happens, off by default.

The tracer.  :func:`tracing` turns it on for the process.  Off, ``span``
returns one shared null context after a single check of the module flag
``enabled``, and ``count`` returns after the same check: nothing is recorded
and no profiler is called.  On, a span is a
``torch.profiler.record_function(name)`` and reads ``time.perf_counter()``
just before the range's entry and just before its exit, where the profiler
stamps the range's two ends; so under :func:`trace` (or any active profiler)
it is a ``user_annotation`` range of the same Chrome trace as the device's
kernels and copies, whose launches it encloses, and its seconds are the
range's.  Each thread keeps its own stack of open spans: a span's parent is
the innermost open span of its thread.  Totals are kept per name (count,
seconds, self seconds: the seconds not covered by child spans) and per
counter; :func:`reset` zeroes them.  :func:`snapshot` returns them with a
copy of each dict of counts a module gave to :func:`register` (the conv
kernels' ``LAUNCHES``), which ``reset`` leaves to its module.  No per-span
list is kept: the profiler's trace is the timeline.  The tracer adds no
device synchronisation: a span is host time, and the device time of the
work launched inside it comes from the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format).  Yields the profiler, whose
    ``key_averages()`` tables the recorded ops."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for profiler traces: ``with annotate('generate'): ...``"""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall-clock stats + optional jsonl log.

    Usage::
        timer = StepTimer(log_path)
        with timer.step():
            ... one training step ...
        print(timer.summary())
    """

    def __init__(self, log_path: str | None = None, warmup_steps: int = 1):
        self.log_path = log_path
        self.warmup_steps = warmup_steps
        self.times: list[float] = []
        self._n = 0
        self._sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup_steps:
            self.times.append(dt)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps({"step": self._n, "seconds": dt}) + "\n")

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {"steps": n,
                "mean_s": sum(ts) / n,
                "p50_s": ts[n // 2],
                "p90_s": ts[min(n - 1, int(0.9 * n))],
                "steps_per_s": n / sum(ts)}


def device_memory_stats():
    """``torch.cuda.memory_stats`` of each CUDA device, keyed ``cuda:i``;
    {} without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

enabled = False  # read as ``profiling.enabled`` at each use; set by tracing()
_clock = time.perf_counter
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_spans: dict[str, list] = {}  # name -> [count, seconds, self seconds]
_counters: dict[str, float] = {}
_registered: dict[str, dict] = {}  # name -> a module's own counts


class _Span:
    __slots__ = ("name", "t0", "child_s", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.child_s = 0.0
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = _clock()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        with _lock:
            tot = _spans.get(self.name)
            if tot is None:
                tot = _spans[self.name] = [0, 0.0, 0.0]
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.child_s
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A named host interval: ``with span("predict.resample"): ...``.  Off,
    the shared null context; on, recorded in the totals and as a profiler
    range."""
    if not enabled:
        return _NULL
    return _Span(name)


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def register(name: str, counts: dict):
    """Have :func:`snapshot` copy ``counts``, a dict a module keeps and
    zeroes itself, under ``name``."""
    _registered[name] = counts


def tracing(on: bool) -> bool:
    """Turn the tracer on or off for the process; returns the previous state."""
    global enabled
    was, enabled = enabled, bool(on)
    return was


def reset():
    """Zero the span totals and the counters (not the registered counts)."""
    with _lock:
        _spans.clear()
        _counters.clear()


def snapshot() -> dict:
    """``{"spans": {name: {count, seconds, self_seconds}}, "counters": {name:
    value}}`` since the last :func:`reset`, and a copy of each registered
    dict of counts under its name (``"launches"``: ``ops/conv_cf.LAUNCHES``
    as it stands)."""
    with _lock:
        spans = {name: {"count": c, "seconds": s, "self_seconds": ss}
                 for name, (c, s, ss) in _spans.items()}
        counters = dict(_counters)
    return {"spans": spans, "counters": counters,
            **{name: dict(counts) for name, counts in _registered.items()}}
