"""CLI entry point of the port: SDXL LoRA-ESD training.

    python -m leco_tpu_torch.train_lora_xl --config_file <yaml> [--device cuda]
    torchrun --nproc_per_node N -m leco_tpu_torch.train_lora_xl --config_file <yaml>

The JAX package's `train_lora_xl.py` (the reference's train_lora_xl.py:
397-407) plus `--device`: `leco_tpu_torch.train_lora`'s steps with the
model loaded by `load_models_xl` and prompts encoded by both text encoders
(`prompts.make_encode_fn_xl`: each encoder's penultimate hidden state
concatenated, the pooled embedding from encoder 2). `cuda` (the default)
raises when there is no GPU rather than running on the CPU; the CPU tests
pass `--device cpu`. Under a launcher it takes data and tensor parallelism
as `train_lora` does (a (dp, tp) mesh; `spatial_parallel != 1` is refused).
"""

from __future__ import annotations

from leco_tpu_torch import train_lora
from leco_tpu_torch.train_lora import parse_args


def main(args, on_step=None) -> dict:
    """Train as the config says; returns `train()`'s result. `on_step(i,
    loss)` is `train()`'s optional observer hook."""
    return train_lora.main(args, on_step=on_step, xl=True)


if __name__ == "__main__":
    main(parse_args())
