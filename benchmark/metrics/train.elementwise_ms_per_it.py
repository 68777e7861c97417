"""Device time of the kernels the category table files as elementwise, in
the profiled pair, per iteration."""

LAYER = "UNet forward (models/unet.py, lora.py)"
UNIT, MOVES, SOURCE = "ms/it", "train_it_per_s", "device_trace"


def read(record: dict):
    t = record.get("trace")
    if not t:
        return None
    return t["by_category_ms"].get("elementwise", 0.0) / t["iterations"]
