"""Device time of NCHW<->NHWC conversions and copies, in the profiled pair,
per iteration."""

LAYER = "UNet forward (models/unet.py, lora.py)"
UNIT, MOVES, SOURCE = "ms/it", "train_it_per_s", "device_trace"


def read(record: dict):
    t = record.get("trace")
    if not t:
        return None
    cats = t["by_category_ms"]
    return (cats.get("NCHW<->NHWC", 0.0) + cats.get("copies", 0.0)) / t["iterations"]
