"""SDXL text-to-image smoke script: load SDXL, encode a prompt with both text
encoders, denoise with DDIM, decode with the VAE and write PNGs.

    python -m leco_tpu_torch.scripts.infer_xl <SDXL diffusers dir or file> \
        [--device cuda|cpu]

Counterpart of `test/infer_xl.py` (the reference's only test): "a photo of
lemonade", 16 DDIM steps at 1024x768, guidance 7, seed 0, noise offset
0.0357, the models in bf16 (`load_models_xl`) and the VAE decoder in fp32
(`load_vae_decoder`, the model dir's `vae/`), the PNGs written as
`output_<i>.png` in the working directory. `--device` defaults to cuda and
raises without a GPU.
"""

from __future__ import annotations

import argparse

import torch

SDXL_NOISE_OFFSET = 0.0357  # reference test/infer_xl.py:26
DDIM_STEPS = 16
HEIGHT, WIDTH = 1024, 768
PROMPT = "a photo of lemonade"
NEGATIVE_PROMPT = ""


def main(argv=None) -> list[str]:
    from leco_tpu_torch.infer import (
        GenerationConfig,
        decode_latents,
        generate_latents,
        save_images,
    )
    from leco_tpu_torch.models.loader import load_models_xl, load_vae_decoder
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.train_lora import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("model", help="SDXL diffusers dir or single file")
    ap.add_argument("--device", default="cuda",
                    help="torch device to generate on (default cuda; no fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    models = load_models_xl(args.model, "ddim", weight_dtype=torch.bfloat16,
                            attn_backend=default_backend(device),
                            device=device, checkpoint_unet=False)
    vae = load_vae_decoder(args.model, torch.float32, device)
    gen = GenerationConfig(height=HEIGHT, width=WIDTH,
                           num_inference_steps=DDIM_STEPS, guidance_scale=7.0, seed=0,
                           noise_offset=SDXL_NOISE_OFFSET)
    latents = generate_latents(models, PROMPT, NEGATIVE_PROMPT, gen)
    paths = save_images(decode_latents(models, latents, vae), prefix="output")
    print("saved:", paths)
    return paths


if __name__ == "__main__":
    main()
