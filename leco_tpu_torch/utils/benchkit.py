"""Shared record-keeping of the port's measurement entry points
(`leco_tpu_torch/bench.py`, `scripts/bench_full.py`, `scripts/bench_xl.py`),
and the chained-carry timer of the conv microbenchmarks
(`scripts/{bench_convs,bench_pallas_conv,ab_convfold}.py`).

Counterpart of the part of `leco_tpu/utils/benchkit.py` that is not about
the TPU: the `LECO_*` knobs of a record and the seeded `timesteps_to`
sample. Added here: the card's
name and power limit as `nvidia-smi` reports them, and whether the kernels'
library was built inside the measured window (the counterpart of the JAX
records' compile-cache state). The JAX module's history file, supervisor,
stall watchdog, status file and cache listing have no counterpart: the
entry points print their record as one JSON line, and the benchmark
(`BENCHMARK.json`) keeps the measurements.
"""

from __future__ import annotations

import math
import os
import subprocess
import time
from pathlib import Path
from typing import Callable

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def knobs() -> dict[str, str]:
    """Every `LECO_*` environment variable of this run, sorted by name."""
    return {k: v for k, v in sorted(os.environ.items()) if k.startswith("LECO_")}


def timesteps_to_sample(n: int, max_steps: int = 50, seed: int = 0) -> list[int]:
    """The seeded `timesteps_to` draws the JAX benches time (bench.py:174-175,
    scripts/bench_xl.py:108-109): U[1, max_steps) from
    `np.random.default_rng(seed)`."""
    return [int(t) for t in np.random.default_rng(seed).integers(1, max_steps, size=n)]


def device_record() -> dict:
    """The card's name and power limit from `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` (the first card's line), or the
    reason the query failed."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": None, "error": f"{type(e).__name__}: {e}"}
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    name, _, limit = line.rpartition(",")
    if not name:
        return {"nvidia_smi": line, "error": "unexpected nvidia-smi output"}
    return {"nvidia_smi": line, "name": name.strip(), "power_limit": limit.strip()}


def platform(device) -> str:
    """The JAX records' platform name of a torch device: "gpu" or "cpu"."""
    import torch

    return "gpu" if torch.device(device).type == "cuda" else torch.device(device).type


def kernel_library(device) -> tuple[bool, float]:
    """Load the kernels' library for a CUDA `device` -> (whether nvcc ran
    now, seconds taken). It is not built now when this process has loaded
    it already or `kernels/_build/` holds it for these sources. On the CPU
    no kernel runs: (False, 0.0)."""
    import torch

    if torch.device(device).type != "cuda":
        return False, 0.0
    from leco_tpu_torch.kernels import build

    loaded = build.library.cache_info().currsize > 0
    on_disk = (build.BUILD_ROOT / build.source_hash() / build.LIB_NAME).exists()
    t0 = time.perf_counter()
    build.library()
    return not (loaded or on_disk), time.perf_counter() - t0


def backend_flags() -> dict:
    """The cuDNN and TF32 settings a measurement ran under (the scripts
    leave them as the process has them)."""
    import torch

    return {"cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def chained_times(fn: Callable, x, iters: int = 64, repeats: int = 1) -> dict:
    """Time `iters` calls of `fn` chained through the carry (c = fn(c),
    starting from `x`) after one warm pass of as many calls.

    Returns {"s": the best over `repeats` passes of the seconds a call,
    "device_ms": the device's own ms a call, or None}. On a CUDA `x` a pass
    is timed by CUDA events (the host's launches count), and `device_ms` is
    `kernels.timing.device_ms` over the same chain (the carry back to `x`
    every `iters` calls): the median of `repeats` samples of `iters` calls.
    On the CPU a pass is timed by the host clock and no device time exists.
    So `fn` runs (1 + repeats) x iters times, and on the card as often
    again as `device_ms` calls it."""
    import torch

    if iters < 1 or repeats < 1:
        raise ValueError(f"iters {iters} and repeats {repeats} must be positive")
    on_card = x.is_cuda

    def chain():
        c = x
        for _ in range(iters):
            c = fn(c)
        return c

    chain()
    if on_card:
        torch.cuda.synchronize(x.device)
    best = math.inf
    for _ in range(repeats):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    device_ms = None
    if on_card:
        from leco_tpu_torch.kernels import timing

        carry = {"c": x, "n": 0}

        def step():
            if carry["n"] % iters == 0:
                carry["c"] = x
            carry["c"] = fn(carry["c"])
            carry["n"] += 1

        device_ms = timing.device_ms(step, calls=iters, repeats=repeats, warmup=0)
    return {"s": best, "device_ms": device_ms}
