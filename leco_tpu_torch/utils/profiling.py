"""Profiling hooks: a `torch.profiler` trace around a region, and a step
timer.

Counterpart of `leco_tpu/utils/profiling.py` (the same API and summary
keys). Usage:

    with trace_if("/tmp/leco-trace", enabled=args.profile):
        train(...)

writes a Chrome trace (`trace.json`, open it in Perfetto or
chrome://tracing) with the CPU and, where there is a GPU, the CUDA
activity; or per-iteration times with `StepTimer` as the trainer's
`on_step` hook.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True):
    """torch.profiler trace of the block, written to `log_dir/trace.json`
    when the block ends (nothing when `enabled` is false)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """on_step hook: records the wall-clock time of each iteration and
    reports it/s. The first `warmup` steps (the kernels' build, cuDNN's
    autotuning) are left out of the average."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: Optional[float] = None

    def __call__(self, i: int, loss: float) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def steady_state_times(self) -> list[float]:
        return self.times[self.warmup :]

    @property
    def its_per_sec(self) -> float:
        ts = self.steady_state_times
        return len(ts) / sum(ts) if ts else 0.0

    def summary(self) -> dict:
        ts = self.steady_state_times
        if not ts:
            return {"its_per_sec": 0.0}
        return {
            "its_per_sec": self.its_per_sec,
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
            "n": len(ts),
        }
