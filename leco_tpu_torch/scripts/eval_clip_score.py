"""The erased-concept CLIP-score delta of a trained LoRA.

    python -m leco_tpu_torch.scripts.eval_clip_score --model <SD dir or file> \
        --clip <CLIP dir> --lora <name>_last.safetensors --concept "van gogh" \
        [--rank 4] [--seeds 0 1 2 3] [--steps 20] [--device cuda|cpu]

Counterpart of `scripts/eval_clip_score.py`: same-seed images with the LoRA
off (multiplier 0) and on (`--multiplier`), each scored against the concept
with CLIP; prints one JSON line {"concept", "base", "erased", "delta"}. The
UNet and text encoder run in bf16, the VAE decoder and CLIP in fp32, as in
the JAX script. All models are local. `--device` defaults to cuda and
raises without a GPU.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    import torch

    from leco_tpu_torch.eval import CLIPScorer, erased_concept_delta
    from leco_tpu_torch.infer import GenerationConfig, decode_latents, generate_latents
    from leco_tpu_torch.lora import LoRASpec, load_lora_weights, lora_parameters
    from leco_tpu_torch.models.loader import load_models, load_vae_decoder
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.train_lora import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--clip", required=True)
    ap.add_argument("--lora", required=True)
    ap.add_argument("--concept", required=True)
    ap.add_argument("--prompts", nargs="*", default=None)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--network", default="lierla")
    ap.add_argument("--v2", action="store_true")
    ap.add_argument("--v_pred", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--multiplier", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; no fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = LoRASpec(rank=args.rank, alpha=args.alpha, network_type=args.network)
    models = load_models(args.model, "ddim", v2=args.v2, v_pred=args.v_pred,
                         weight_dtype=torch.bfloat16, lora_spec=spec,
                         attn_backend=default_backend(device), device=device)
    lora = load_lora_weights(args.lora, lora_parameters(models.unet))
    vae = load_vae_decoder(args.model, torch.float32, device)
    scorer = CLIPScorer.from_pretrained(args.clip, device=device)

    def generate_fn(prompt, seed, multiplier):
        gen = GenerationConfig(height=args.resolution, width=args.resolution,
                               num_inference_steps=args.steps, guidance_scale=7.0, seed=seed)
        return generate_latents(models, prompt, "", gen, lora=lora, multiplier=multiplier)

    def decode_fn(latents):
        return decode_latents(models, latents, vae=vae)

    result = erased_concept_delta(scorer, decode_fn, generate_fn, args.concept,
                                  prompts=args.prompts, seeds=tuple(args.seeds),
                                  multiplier=args.multiplier)
    record = {"concept": args.concept, **result}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
