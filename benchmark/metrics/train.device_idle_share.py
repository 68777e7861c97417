"""One minus the traced pair's device busy time (the union of device
activity) over the untraced window's time for one pair. Every pair does
the same work, so the untraced window gives the pair's time without the
profiler, which slows the host (and so the traced pair's own wall clock)
1.3-2.3x."""

LAYER = "device (H100)"
UNIT, MOVES, SOURCE = "%", "train_it_per_s", "device_trace"


def read(record: dict):
    t = record.get("trace")
    if not t:
        return None
    pair_s = record["window_s"] * t["iterations"] / record["attempted"]
    return 100.0 * (1.0 - t["busy_s"] / pair_s)
