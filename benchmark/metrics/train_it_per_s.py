"""Iterations completed over the window's seconds, all of it: the time to
train an adapter is iterations / this, over the recipe's t_to distribution."""

LAYER, UNIT, MOVES, SOURCE = None, "it/s", None, "host_clock"


def read(record: dict):
    return record["attempted"] / record["window_s"]
