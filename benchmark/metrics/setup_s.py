"""Process start to the first timed iteration: imports, the kernels'
library (built on a checkout's first run, then loaded), the weights drawn
on the card, the program's objects and the set-up pairs."""

LAYER, UNIT, MOVES, SOURCE = None, "s", None, "host_clock"


def read(record: dict):
    return record["setup_s"]
