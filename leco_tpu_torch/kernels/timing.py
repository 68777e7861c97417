"""Device time of one call, read from torch.profiler, and the L2 rotation
that keeps a byte-bound call from finding its input in the cache.

`device_ms(fns)` runs the calls `fns` in turn (one call each: `calls` calls
per sample) under `torch.profiler`, sums the device time of every kernel,
memset and copy those calls put on the card (`self_device_time_total` of
the profiler's CUDA events, user annotations left out), divides by the
calls, and returns the median over `repeats` samples. Unlike CUDA events around the calls, it does not
count the host's time between launches.

The profiler loses device records now and then (torch 2.11 on an H100):
late in a long process (after the phases of `chip_smoke.py` up to its
phase bench) the first 20 or so of every session, so that 16 short
convolution calls kept 12 of their 32 kernels and read 0.013 ms for a
0.035 ms call; in a fresh process now and then the records of the first
millisecond or so; and, once in some 75 sessions, every record of a
session. So a session (`profiled`) first runs `lead_and_mark`:
LEAD_KERNELS tiny kernels and a spin of about 10 ms, a synchronize, and a
marker kernel (`torch.cuda._sleep`, PyTorch's `spin_kernel`); then each
call it measures, each followed by another marker. Only what starts after
the first marker counts, the markers left out (`marked`: device timestamps
only, since the host's and the device's clocks disagree by milliseconds in
the profile; a backward's kernels, launched from autograd's own thread,
count too). A session that kept its records has one marker more than
calls, device records between each two and none after the last; where the
calls are alike (`alike`: the forwards and train steps that the profilers
trace), the same number between each two, which holds a loss anywhere in
the session, not only at its start. A session that fails this is taken
again, at most ATTEMPTS times, and then `LostRecords` raises instead of
reading low. (`device_ms` does not ask for alike calls: an optimizer's
step may branch on its state.)

The pure parts (`rotation_count`, `per_call_ms`, `marked`, `median`) are
what the CPU tests hold; `device_ms` and `profiled` need a CUDA device.
"""

from __future__ import annotations

import bisect
import math
import statistics

L2_BYTES = 50 * 2**20  # H100 (SXM and PCIe): 50 MB of L2
MARKER = "spin_kernel"  # `torch.cuda._sleep`'s kernel: the lead's wait and the marker
MARKER_MAX_US = 100.0  # the marker spins 1 cycle; the lead's spin, milliseconds
ATTEMPTS = 5  # sessions `profiled` takes before it raises
LEAD_KERNELS, LEAD_CYCLES = 64, 20_000_000  # tiny kernels, then a spin of about 10 ms


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


class LostRecords(RuntimeError):
    """The profiler dropped device records of a session (`marked`)."""


def lead_and_mark() -> None:
    """Inside a profiled session, before the work it measures: launch
    LEAD_KERNELS tiny kernels and a spin of LEAD_CYCLES (the records the
    profiler may drop: its first records, or those of its first
    milliseconds), wait for them, and launch the marker kernel that
    `marked` cuts at."""
    import torch

    lead = torch.zeros(1, device="cuda")
    for _ in range(LEAD_KERNELS):
        lead.add_(1)
    torch.cuda._sleep(LEAD_CYCLES)
    torch.cuda.synchronize()
    torch.cuda._sleep(1)


def marked(events, calls: int = 1, alike: bool = False) -> list:
    """A session's events after its first marker kernel (`lead_and_mark`;
    a MARKER kernel shorter than MARKER_MAX_US), the markers left out: the
    device events, kernels and annotations, that start after it ended, and
    every host event. Raises LostRecords unless the session holds `calls` + 1
    markers, each of the `calls` calls between two of them holds device
    records (with `alike`, as many as each other call), and none follows
    the last."""
    from torch.autograd import DeviceType

    kernels = device_events(events)
    marks = [e for e in kernels
             if MARKER in e.name and e.time_range.elapsed_us() < MARKER_MAX_US]
    if len(marks) != calls + 1:
        names = sorted({e.name[:40] for e in kernels})
        raise LostRecords(f"{len(marks)} {MARKER!r} marker kernels, not {calls + 1}, among "
                          f"the profile's {len(kernels)} device records {names[:6]}")
    ends = sorted(e.time_range.end for e in marks)
    skip = {id(e) for e in marks}
    per_call = [0] * (calls + 1)
    for e in kernels:
        if id(e) not in skip and e.time_range.start >= ends[0]:
            per_call[bisect.bisect_right(ends, e.time_range.start) - 1] += 1
    if per_call[-1] or min(per_call[:-1]) < 1 or (alike and len(set(per_call[:-1])) != 1):
        raise LostRecords(f"device records a call {per_call[:-1]}, {per_call[-1]} after "
                          f"the last marker")
    return [e for e in events if id(e) not in skip
            and (e.device_type != DeviceType.CUDA or e.time_range.start >= ends[0])]


def profiled(fn, device="cuda", calls: int = 1, alike: bool = False) -> tuple:
    """`calls` calls of `fn()` under torch.profiler after `lead_and_mark`,
    each followed by a marker and the last by a synchronize, until a session
    keeps its records (at most ATTEMPTS sessions) -> (the profile, the
    `marked(events, calls, alike)` events of that session). On the CPU, where no device records
    exist, one session of host events: (the profile, all its events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                fn()
        return prof, list(prof.events())
    lost = []
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_and_mark()
            for _ in range(calls):
                fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        try:
            return prof, marked(prof.events(), calls, alike)
        except LostRecords as e:
            lost.append(str(e))
    raise LostRecords(f"{ATTEMPTS} sessions lost records: {lost}")


def median(samples) -> float:
    samples = list(samples)
    if not samples:
        raise ValueError("no samples")
    return statistics.median(samples)


def device_ms(fns, calls: int = 10, repeats: int = 5, warmup: int = 2) -> float:
    """Median over `repeats` profiler samples of the device time per call;
    each sample makes `calls` calls, cycling through `fns` (one callable, or
    a sequence of them to rotate over input copies), in a session that
    kept its records (`profiled`: each call launches at least one kernel)."""
    import torch

    fns = [fns] if callable(fns) else list(fns)
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    turn = [0]

    def call():
        fns[turn[0] % len(fns)]()
        turn[0] += 1

    samples = [per_call_ms(profiled(call, calls=calls)[1], calls) for _ in range(repeats)]
    if not any(samples):
        raise RuntimeError("the profiler saw no device time")
    return median(samples)
