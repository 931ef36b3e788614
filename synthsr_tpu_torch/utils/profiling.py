"""Tracing and per-step timing: the port of ``synthsr_tpu/utils/profiling.py``
(the reference has only a LoopInfo ETA printer).

- :func:`trace` records ``torch.profiler`` (the CPU, and the CUDA device when
  there is one) and writes a Chrome trace, viewable in Perfetto;
- :func:`annotate` is a named region in that trace
  (``torch.profiler.record_function``);
- :class:`StepTimer` keeps per-step wall-clock times, synchronising the CUDA
  device around each step when there is one, so a step's time includes its
  kernels; it appends each step to an optional jsonl log;
- :func:`device_memory_stats` returns ``torch.cuda.memory_stats`` per device.
"""

from __future__ import annotations

import contextlib
import json
import os
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
