"""Device time of one call, read from torch.profiler, and the L2 rotation
that keeps a byte-bound call from finding its input in the cache.

`device_ms(fns)` runs the calls `fns` in turn (one call each: `calls` calls
per sample) under `torch.profiler`, sums the device time of every kernel,
memset and copy those calls put on the card (`self_device_time_total` of
the profiler's CUDA events, user annotations left out), divides by the
calls, and returns the median over `repeats` samples. Unlike CUDA events around the calls, it does not
count the host's time between launches.

For a byte-bound function, `rotation_count(nbytes)` gives how many copies
of its input to rotate over so that their total exceeds twice the card's
L2 cache: a copy is then evicted before the rotation returns to it, and
each call reads its input from device memory, as the roofline bound
counts it.

The pure parts (`rotation_count`, `per_call_ms`, `median`) are what the CPU
tests hold; `device_ms` needs a CUDA device.
"""

from __future__ import annotations

import math
import statistics

L2_BYTES = 50 * 2**20  # H100 (SXM and PCIe): 50 MB of L2


def rotation_count(nbytes: float, l2_bytes: float = L2_BYTES, factor: float = 2.0) -> int:
    """The fewest copies of an `nbytes` input whose total exceeds `factor`
    times `l2_bytes` (at least 1)."""
    if nbytes <= 0:
        raise ValueError(f"a copy of {nbytes} bytes")
    return max(1, math.floor(factor * l2_bytes / nbytes) + 1)


def device_events(events) -> list:
    """The profiler's events that the device executed: kernels, memsets and
    copies. A `record_function` range (`torch.optim` wraps every `step()` in
    one) also shows on the device timeline, as a user annotation whose time
    spans the range, idle gaps included: it is left out."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def per_call_ms(events, calls: int) -> float:
    """The summed self device time (microseconds) of `device_events` over
    `calls` calls -> milliseconds per call."""
    return sum(e.self_device_time_total for e in device_events(events)) / calls / 1e3


def median(samples) -> float:
    samples = list(samples)
    if not samples:
        raise ValueError("no samples")
    return statistics.median(samples)


def device_ms(fns, calls: int = 10, repeats: int = 5, warmup: int = 2) -> float:
    """Median over `repeats` profiler samples of the device time per call;
    each sample makes `calls` calls, cycling through `fns` (one callable, or
    a sequence of them to rotate over input copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fns = [fns] if callable(fns) else list(fns)
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    samples = []
    turn = 0
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fns[turn % len(fns)]()
                turn += 1
            torch.cuda.synchronize()
        samples.append(per_call_ms(prof.key_averages(), calls))
    if not any(samples):
        raise RuntimeError("the profiler saw no device time")
    return median(samples)
