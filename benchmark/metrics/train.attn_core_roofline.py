"""The forward attention cores' roofline share: the least time of their
work (every attn1 and attn2 core of every forward of the profiled pair; q,
k, v read once and o written once) over the device time of the kernels
launched inside the attn1 and attn2 core scopes."""

LAYER = "kernels (ops/attention.py, ops/flash_attention.py, kernels/csrc/flash_*.cu)"
UNIT, MOVES, SOURCE = "%", "train_it_per_s", "device_trace"


def read(record: dict):
    t = record.get("trace")
    if not t or t["core_ms"] <= 0:
        return None
    return 100.0 * t["core_bound_ms"] / t["core_ms"]
