"""The pure parts of the port's device-time helper
(`leco_tpu_torch/kernels/timing.py`): how many input copies defeat the L2,
and the per-call device time from the profiler's events, fed fake events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

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


def test_device_ms_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        timing.device_ms(lambda: None)
