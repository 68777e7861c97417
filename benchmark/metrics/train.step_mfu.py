"""The whole step's share of the card's bf16 dense peak: the FLOPs counted
over the reference UNet for the untraced window's iterations, over the
window's seconds times 989 TFLOP/s (the power limit is in `device`)."""

LAYER = "train step (make_train_step as a whole)"
UNIT, MOVES, SOURCE = "%", "train_it_per_s", "host_clock"


def read(record: dict):
    if not record.get("window_flops"):
        return None
    return 100.0 * record["window_flops"] / (record["window_s"] * record["peak_flops"])
