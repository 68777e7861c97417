"""CLI entry point of the port: textual-inversion erasure (SD v1.x / v2.x).

    python -m leco_tpu_torch.train_ti --config_file <yaml> [--device cuda]

The JAX package's `train_ti.py`: the same YAML schema as `train_lora`
(`examples/ti_config.yaml`), but the trainable is the target prompt's token
embeddings, exported as an A1111 embedding
(`leco_tpu_torch/train/textual_inversion.py`). The model loads as the JAX
CLI loads it (`v2`, `v_pred`, `clip_skip`, precision, `checkpoint_unet`),
without LoRA layers: the UNet runs on its base weights. The prompts are
encoded once to the final-LayerNorm `last` state; the step splices the
trained rows in and encodes the target again, with grad, on every
iteration. `--device` is `train_lora`'s: `cuda` (the default) raises when
there is no GPU rather than running on the CPU. Prints the saved files.
"""

from __future__ import annotations

from leco_tpu_torch.train_lora import parse_args, resolve_device


def main(args, on_step=None) -> dict:
    """Train as the config says; returns `train_textual_inversion`'s result.
    `on_step(i, loss)` is its optional observer hook."""
    from leco_tpu_torch.config import load_config_from_yaml, parse_precision
    from leco_tpu_torch.models.loader import load_models
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.prompts import load_prompts_from_yaml, make_encode_fn
    from leco_tpu_torch.train.textual_inversion import (
        TextEncoderHandle,
        train_textual_inversion,
    )
    from leco_tpu_torch.train.trainer import ModelBundle

    device = resolve_device(args.device)
    config = load_config_from_yaml(args.config_file)
    prompts = load_prompts_from_yaml(config.prompts_file)
    model = config.pretrained_model
    models = load_models(
        model.name_or_path,
        scheduler_name=config.train.noise_scheduler,
        v2=model.v2,
        v_pred=model.v_pred,
        weight_dtype=parse_precision(config.train.precision),
        clip_skip=model.clip_skip,
        attn_backend=default_backend(device),
        device=device,
        checkpoint_unet=config.train.checkpoint_unet,
    )
    bundle = ModelBundle(unet=models.unet, scheduler=models.scheduler, spec=None,
                         device=device,
                         encode_fn=make_encode_fn(models.tokenizer, models.text_encoder, device))
    handle = TextEncoderHandle(model=models.text_encoder, tokenizer=models.tokenizer,
                               device=device)
    result = train_textual_inversion(config, prompts, bundle, handle, on_step=on_step)
    print(f"saved: {[str(p) for p in result['saved']]}")
    return result


if __name__ == "__main__":
    main(parse_args())
