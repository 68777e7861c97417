"""The pure parts of the port's device-time helper
(`leco_tpu_torch/kernels/timing.py`): how many input copies defeat the L2,
the per-call device time from the profiler's events, fed fake events, and
the window of timed calls that each profiled sample counts."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from leco_tpu_torch.kernels import timing


def test_the_l2_is_50_mib():
    assert timing.L2_BYTES == 52_428_800


@pytest.mark.parametrize("nbytes,l2,copies", [
    (2 * 320 * 64 * 64 * 2, timing.L2_BYTES, 21),  # (2, 320, 64^2) bf16: 5.2 MB
    (3 * 320 * 64 * 64 * 2, timing.L2_BYTES, 14),
    (2 * 1280 * 8 * 8 * 2, timing.L2_BYTES, 321),  # exactly 320 fill it
    (100, 1000, 21),  # exactly 2 x l2 / nbytes = 20: one more to exceed it
    (101, 1000, 20),
    (5000, 1000, 1),  # one copy already exceeds twice the cache
])
def test_rotation_count_exceeds_twice_the_l2(nbytes, l2, copies):
    got = timing.rotation_count(nbytes, l2)
    assert got == copies
    assert got * nbytes > 2 * l2 or got == 1
    assert got == 1 or (got - 1) * nbytes <= 2 * l2  # the fewest that do


def test_rotation_count_refuses_an_empty_input():
    with pytest.raises(ValueError):
        timing.rotation_count(0)


def _event(us, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(device_type=device, self_device_time_total=us,
                           is_user_annotation=annotation)


def test_per_call_ms_sums_the_device_events_only():
    events = [_event(30.0), _event(10.0), _event(5.0), _event(1000.0, DeviceType.CPU)]
    assert timing.per_call_ms(events, calls=10) == pytest.approx(0.0045)


def test_per_call_ms_leaves_out_user_annotations():
    """An optimizer's `step()` range on the device timeline spans its idle
    gaps; only the kernels inside it count."""
    events = [_event(9630.0, annotation=True), _event(500.0), _event(260.0),
              _event(9700.0, DeviceType.CPU, annotation=True)]
    assert timing.per_call_ms(events, calls=1) == pytest.approx(0.76)
    assert timing.device_events(events) == events[1:3]


def test_per_call_ms_of_no_device_events_is_zero():
    assert timing.per_call_ms([_event(50.0, DeviceType.CPU)], calls=3) == 0.0


def test_median_over_samples_of_per_call_sums():
    samples = [timing.per_call_ms([_event(us), _event(2 * us)], calls=10)
               for us in (10.0, 40.0, 20.0, 30.0, 1000.0)]
    assert timing.median(samples) == pytest.approx(0.009)  # the 30 us sample: 90 us / 10
    assert timing.median([1.0, 3.0]) == 2.0
    with pytest.raises(ValueError):
        timing.median([])


def _span(i, name, start, end, annotation=False, device=DeviceType.CUDA):
    return FunctionEvent(id=i, name=name, thread=0, start_us=start, end_us=end,
                         use_device="cuda", device_type=device, is_user_annotation=annotation)


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_marked_keeps_what_follows_the_marker():
    """The lead kernels, the lead's long spin and the short marker spins are
    left out; the device events that start after the first marker,
    annotations included, and every host event are kept, a backward's
    kernels from autograd's thread among them."""
    lead = [_span(1, "add", 0, 1), _span(2, SPIN, 1, 10001)]
    first = [_span(3, "conv", 10020, 10030), _span(4, "mul", 10030, 10032)]
    second = [_span(5, "conv", 10040, 10050), _span(8, "dgrad", 10050, 10053)]
    scope = _span(6, "leco/unet/other", 10020, 10053, annotation=True)
    host = _span(7, "aten::conv2d", 3, 10021, device=DeviceType.CPU)
    events = (lead + [_span(9, SPIN, 10015, 10016)] + first + [_span(10, SPIN, 10033, 10034)]
              + second + [_span(11, SPIN, 10054, 10055), scope, host])
    assert timing.marked(events, calls=2, alike=True) == first + second + [scope, host]
    assert timing.per_call_ms(timing.marked(events, calls=2), calls=2) == \
        pytest.approx(0.0125)
    # the lead dropped by the profiler: the first marker alone bounds the window
    assert timing.marked(events[2:], calls=2) == first + second + [scope, host]
    # one call: the lead's marker and the call's
    one = lead + [_span(9, SPIN, 10015, 10016)] + first + [_span(10, SPIN, 10033, 10034)]
    assert timing.marked(one) == first


def _session(*per_call, after=0, lead_marker=True):
    """A session's device events: the lead's marker (unless dropped), then
    per call its kernels and a marker, then `after` kernels."""
    events, t, i = [_span(1, SPIN, 0, 10000)], 10010, 2
    if lead_marker:
        events.append(_span(i, SPIN, t, t + 1))
    for n in per_call:
        for _ in range(n):
            i, t = i + 1, t + 10
            events.append(_span(i, "conv", t, t + 5))
        i, t = i + 1, t + 10
        events.append(_span(i, SPIN, t, t + 1))
    for _ in range(after):
        i, t = i + 1, t + 10
        events.append(_span(i, "conv", t, t + 5))
    return events


@pytest.mark.parametrize("events,calls,alike,why", [
    (_session(2, lead_marker=False), 1, False, "1 'spin_kernel' marker kernels, not 2"),
    (_session(2, 1), 2, True, r"device records a call \[2, 1\]"),
    (_session(2, 2, 2, after=1), 3, False, "1 after the last marker"),
    (_session(2, 0), 2, False, r"device records a call \[2, 0\]"),
    (_session(2, 2), 3, True, "3 'spin_kernel' marker kernels, not 4"),
], ids=["marker_lost", "calls_lost", "record_after_the_last_marker", "empty_call",
        "call_marker_lost"])
def test_marked_refuses_a_session_that_lost_records(events, calls, alike, why):
    """The profiler dropped records the sample depends on: the session is
    refused (`profiled` takes it again), not read low."""
    with pytest.raises(timing.LostRecords, match=why):
        timing.marked(events, calls, alike)


def test_marked_holds_alike_calls_to_one_count():
    """Alike calls with as many records each are kept; calls that are not
    asked to be alike may differ (an optimizer step that branches)."""
    assert len(timing.marked(_session(3, 3, 3), 3, alike=True)) == 9
    assert len(timing.marked(_session(3, 1, 2), 3)) == 6


def test_device_ms_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        timing.device_ms(lambda: None)
