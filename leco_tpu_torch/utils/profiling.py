"""Profiling hooks: the program's recorder of spans and counters, a
`torch.profiler` trace around a region, and a step timer.

Counterpart of `leco_tpu/utils/profiling.py` (the same `trace_if` and
`StepTimer` API and summary keys). Usage:

    with trace_if("/tmp/leco-trace", enabled=args.profile):
        train(...)

writes a Chrome trace (`trace.json`, open it in Perfetto or
chrome://tracing) with the CPU and, where there is a GPU, the CUDA
activity, the train step's phases among it; or per-iteration times with
`StepTimer` as the trainer's `on_step` hook.

The recorder (`span`, `count`, `recording`, `enable`, `take`) is off unless
a block turns it on. Off, `span` hands back one shared no-op context and
`count` returns at once: no allocation, no lock, no torch call. On, a span
keeps its name, its start and end on the profiler's clock (`clock_ns`) and
its parent in memory, and opens a `torch.profiler.record_function` range
of its name, so that a running profiler shows it on its own timeline; a
counter adds to a dict. Spans nest within one thread (the train step's)
and add no device operation and no host sync. Span names start with
`leco.`; the program's spans:

    leco.step                the whole train step (make_train_step)
    leco.fold                the LoRA folded into the base weights
    leco.inner_denoise       the t_to CFG forwards, LoRA folded
    leco.reference_forward   the 3B forward, LoRA off
    leco.target_forward      the differentiated forward
    leco.loss                the fp32 ESD loss
    leco.backward            loss.backward() (and the parallel path's
                             gradient reduction)
    leco.optimizer           optimizer.step()
    leco.kernels.library     loading (or building) the kernels' library
    leco.stage: <message>    train()'s set-up stages, as points

and its counters: `unet.inner_calls` (the UNet calls of the inner denoise)
and `kernels.nvcc_runs` (builds of the kernels' library with nvcc).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

# torch.profiler stamps its CPU events (record_function ranges, operators)
# in CLOCK_REALTIME nanoseconds, converted from the TSC; the recorder's own
# stamps are on the same clock, so its spans join the profiler's events
clock_ns = time.time_ns


class _Off:
    """The one context every span is while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """Spans and counters of the program, held in memory until `take()`."""

    def __init__(self):
        self.on = False
        self.spans: list[list] = []  # [name, start_ns, end_ns, parent index or -1]
        self.counters: dict[str, int] = {}
        self._open: list[int] = []

    def span(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def take(self) -> dict:
        """-> {"spans": [{"name", "start_ns", "end_ns", "parent"}], "counters"},
        what was recorded since the last take; clears it. `parent` is the
        index of the enclosing span in the list, or None."""
        if self._open:
            raise RuntimeError(f"take() inside the open span {self.spans[self._open[-1]][0]!r}")
        spans, counters = self.spans, self.counters
        self.spans, self.counters = [], {}
        return {"spans": [{"name": n, "start_ns": s, "end_ns": e,
                           "parent": None if p < 0 else p} for n, s, e, p in spans],
                "counters": counters}


class _Span:
    __slots__ = ("recorder", "name", "index", "range")

    def __init__(self, recorder: Recorder, name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        from torch.autograd.profiler import record_function

        rec = self.recorder
        self.index = len(rec.spans)
        rec.spans.append([self.name, clock_ns(), None, rec._open[-1] if rec._open else -1])
        rec._open.append(self.index)
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        rec = self.recorder
        rec.spans[self.index][2] = clock_ns()
        rec._open.pop()
        return False


RECORDER = Recorder()  # the process's recorder; the program's spans go to it
span = RECORDER.span
count = RECORDER.count
take = RECORDER.take


def enable(on: bool = True) -> bool:
    """Turn the recorder on or off -> whether it was on."""
    was, RECORDER.on = RECORDER.on, bool(on)
    return was


@contextlib.contextmanager
def recording(on: bool = True):
    """The recorder on (or off) inside the block, as it was after it."""
    was = enable(on)
    try:
        yield RECORDER
    finally:
        enable(was)


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True):
    """torch.profiler trace of the block, written to `log_dir/trace.json`
    when the block ends, with the recorder on inside it, so that the trace
    shows the train step's `leco.` phases (nothing when `enabled` is
    false)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
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
