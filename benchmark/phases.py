"""The train step's phases in the traced pair, from the program's own spans.

While its recorder is on, the program (`leco_tpu_torch.utils.profiling`)
opens a `record_function` range named `leco.<phase>` around each phase of
`make_train_step` and counts the inner denoise's UNet calls. This file
reads those ranges from the traced pair's CPU events (`tracing.profile_pair`'s
session) and the recorder's counters, and gives, by phase:

- `by_phase_ms` and `launches_by_phase`: each device operation goes to the
  innermost `leco.` range that holds its launch's host time (the method of
  `tracing.attribute`, for this prefix). "step" is what runs inside
  `leco.step` but in none of its phases (the timestep lookup, glue);
  operations outside every range go to "outside the step" (the runner's
  latents draw and loss fetch). The phases and "outside the step" add up
  to the pair's device time.
- `idle_by_phase_ms`: each gap in the union of device activity goes to the
  phase of the launch that ends it, the phase the host was in while the
  device waited.
- `inner_calls`: the counter `unet.inner_calls` for the profiled pair.

and, from what the recorder took after set-up, the host seconds of its
`leco.kernels.library` spans and the counter `kernels.nvcc_runs`.
`per_layer` turns these into per-iteration numbers. A program without the
recorder (a checkout before it) has no `leco.` range: then nothing is read.

`phase_table.py` drives this for one cell. The benchmark's runner does not
turn the recorder on, so `run.py`'s result line holds none of these numbers.
"""

from __future__ import annotations

import bisect
import collections

import tracing

PREFIX = "leco."
STEP = "leco.step"
LIBRARY = "leco.kernels.library"
OUTSIDE = "outside the step"
ORDER = ("fold", "inner_denoise", "reference_forward", "target_forward", "loss", "backward",
         "optimizer", "step", OUTSIDE)


def recorder():
    """The program's recorder module (`enable`, `take`), or None where the
    program has none."""
    try:
        from leco_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") and hasattr(profiling, "take") else None


def program_ranges(cpu: list) -> list:
    """The `leco.` ranges among the session's CPU events: (start, end, name)."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
            if e.is_user_annotation() and e.name().startswith(PREFIX)]


def attribute(points: list, ranges: list) -> list:
    """The phase of each time point: the innermost range (start, end, name)
    that holds it, its name without the prefix (the ranges nest), or
    OUTSIDE."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = [OUTSIDE] * len(points)
    stack: list = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(ranges) and ranges[j][0] <= p:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if stack:
            out[i] = stack[-1][2][len(PREFIX):]
    return out


def launch_times(device: list, cpu: list) -> list:
    """The host time at which each device operation was launched: its
    runtime call's start, or its operator's, or its own start (as
    `tracing.analyze` takes it)."""
    runtime_start, frontend = {}, {}
    for e in cpu:
        if e.linked_correlation_id() > 0:
            runtime_start[e.correlation_id()] = e.start_ns()
        else:
            frontend[e.correlation_id()] = e
    out = []
    for e in device:
        t = runtime_start.get(e.correlation_id())
        if t is None:
            op = frontend.get(e.linked_correlation_id())
            t = op.start_ns() if op is not None else e.start_ns()
        out.append(t)
    return out


def read(session: dict, taken: dict) -> dict | None:
    """The traced pair's phases from its session and what the recorder took
    over it (`take()`: spans and counters), or None without `leco.` ranges."""
    device, cpu = session["device"], session["cpu"]
    ranges = program_ranges(cpu)
    if not ranges:
        return None
    phases = attribute(launch_times(device, cpu), ranges)
    device_ns, launches = collections.Counter(), collections.Counter()
    intervals = []
    for e, phase in zip(device, phases):
        device_ns[phase] += e.duration_ns()
        launches[phase] += 1
        intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    order = sorted(range(len(device)), key=lambda i: intervals[i][0])
    _, gaps = tracing._union([intervals[i] for i in order])
    starts = [intervals[i][0] for i in order]
    idle_ns = collections.Counter()
    for g0, g1 in gaps:
        idle_ns[phases[order[bisect.bisect_left(starts, g1)]]] += g1 - g0

    # the recorder's counters cover every session profile_pair took; the
    # CPU events only its last
    recorded = [s for s in taken["spans"] if s["name"].startswith(PREFIX)]
    steps_recorded = sum(1 for s in recorded if s["name"] == STEP)
    steps_traced = sum(1 for r in ranges if r[2] == STEP)
    inner = taken["counters"].get("unet.inner_calls", 0)
    # the recorder's stamps against the profiler's, span by span (the last session's)
    ranges_in_order = sorted(ranges)
    mine = recorded[-len(ranges_in_order):]
    same = [s["name"] for s in mine] == [r[2] for r in ranges_in_order]
    offset_us = (max(max(abs(s["start_ns"] - r[0]), abs(s["end_ns"] - r[1]))
                     for s, r in zip(mine, ranges_in_order)) / 1e3 if same else None)
    ms = 1e-6
    keys = [k for k in ORDER if k in launches] + sorted(set(launches) - set(ORDER))
    return {
        "by_phase_ms": {k: device_ns[k] * ms for k in keys},
        "launches_by_phase": {k: launches[k] for k in keys},
        "idle_by_phase_ms": {k: idle_ns[k] * ms for k in keys if k in idle_ns},
        "device_ms": sum(e.duration_ns() for e in device) * ms,
        "inner_calls": inner * steps_traced / steps_recorded if steps_recorded else None,
        "steps": steps_traced,
        "clock_offset_us": offset_us,
        "annotations_counted": sum(1 for e in device if e.name().startswith(PREFIX)),
    }


def setup(taken: dict) -> dict:
    """What the recorder took over set-up -> its spans and counters, the host
    seconds of its `leco.kernels.library` spans (None without one) and the
    nvcc runs."""
    library = [s for s in taken["spans"] if s["name"] == LIBRARY]
    return {
        "spans": taken["spans"],
        "counters": taken["counters"],
        "kernel_library_s": (sum(s["end_ns"] - s["start_ns"] for s in library) / 1e9
                             if library else None),
        "nvcc_runs": taken["counters"].get("kernels.nvcc_runs", 0),
    }


def per_layer(p: dict, iterations: int, setup_read: dict) -> dict:
    """Per-layer numbers of the traced pair's phases `p` (`read`) over its
    `iterations`, and of set-up (`setup`): device ms an iteration in the
    fold, the backward and the optimizer; the inner denoise's idle over its
    idle and device time, in %; its launches per UNet call; the host seconds
    of the kernels' library."""
    ms, idle = p["by_phase_ms"], p["idle_by_phase_ms"]
    inner = ms.get("inner_denoise", 0.0) + idle.get("inner_denoise", 0.0)
    return {
        "train.fold_ms_per_it": ms.get("fold", 0.0) / iterations,
        "train.backward_ms_per_it": ms.get("backward", 0.0) / iterations,
        "train.optimizer_ms_per_it": ms.get("optimizer", 0.0) / iterations,
        "train.inner_denoise_idle_share": (100.0 * idle.get("inner_denoise", 0.0) / inner
                                           if inner > 0 else None),
        "train.inner_launches_per_forward": (p["launches_by_phase"].get("inner_denoise", 0)
                                             / p["inner_calls"] if p["inner_calls"] else None),
        "setup.kernel_library_s": setup_read["kernel_library_s"],
    }


def table(p: dict, iterations: int, total_ms: float) -> str:
    """The phase table, per iteration, for standard error."""
    lines = [f"phases of the traced pair, an iteration:\n  {'phase':<20}{'device ms':>12}"
             f"{'launches':>10}{'idle ms':>10}"]
    for k in p["launches_by_phase"]:
        lines.append(f"  {k:<20}{p['by_phase_ms'][k] / iterations:>12.3f}"
                     f"{p['launches_by_phase'][k] / iterations:>10.1f}"
                     f"{p['idle_by_phase_ms'].get(k, 0.0) / iterations:>10.3f}")
    summed = sum(p["by_phase_ms"].values())
    lines.append(f"  phases + outside the step {summed:.3f} ms of the pair's {total_ms:.3f} "
                 f"(gap {100 * (summed - total_ms) / total_ms if total_ms else 0.0:+.4f}%); "
                 f"UNet calls in the inner denoise {p['inner_calls']}; steps {p['steps']}; "
                 f"recorder against profiler stamps {p['clock_offset_us']} us; "
                 f"leco. records among the device's {p['annotations_counted']}")
    return "\n".join(lines)
