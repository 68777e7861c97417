"""torch.cuda.max_memory_allocated() over the window, reset at its start:
users train on cards of fixed memory."""

LAYER, UNIT, MOVES, SOURCE = None, "GiB", None, "host_clock"


def read(record: dict):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
