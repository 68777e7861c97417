"""Device operations (kernels, copies, memsets) launched in the profiled
pair, per iteration: a count, which repeats exactly."""

LAYER = "host loop (train/trainer.py make_train_step, train/diffusion.py, ops/schedulers.py, the UNet's module calls)"
UNIT, MOVES, SOURCE = "launches/it", "train_it_per_s", "device_trace"


def read(record: dict):
    t = record.get("trace")
    return t["launches"] / t["iterations"] if t else None
