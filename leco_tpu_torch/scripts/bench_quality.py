"""The tracked quality metric on the port: the synthetic erased-concept
signature delta.

    python -m leco_tpu_torch.scripts.bench_quality [--device cuda|cpu] [--out DIR]

Counterpart of `scripts/bench_quality.py`, the same protocol and bar:

  1. plant a concept in the tiny test UNet: fit its base weights (Adam,
     800 steps) so that the concept's conditioning gives a fixed unit-norm
     signature and the neutral conditioning an orthogonal one;
  2. run the real `train()` ESD erase recipe against it, 150 iterations;
  3. measure the erasure through `eval.erased_concept_delta`, with the
     correlation to the signature in the place of the CLIP score:
     delta = mean corr(multiplier 0) - mean corr(+1).

The signatures and draws come from numpy and torch seeds, so the number is
the port's own and not the JAX record's draw for draw. Prints one JSON line
(it appends to no history file). `--device` defaults to cuda and raises
without a GPU; the protocol is a CPU workload (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

# the committed bar (BASELINE.md, the quality row): the erase-trained LoRA
# at multiplier +1 must cut the planted concept's signature correlation by
# at least this much against multiplier 0
DELTA_BAR = 0.5

CONCEPT = "van gogh"
NEUTRAL = ""
LATENT_SHAPE = (1, 4, 8, 8)
PLANT_STEPS = 800
ITERATIONS = 150


def _cos(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def signatures(seed_concept: int = 1234, seed_neutral: int = 4321):
    """A unit-norm concept signature and an orthogonal unit-norm neutral one."""
    sig = np.random.default_rng(seed_concept).standard_normal(LATENT_SHAPE)
    sig /= np.linalg.norm(sig)
    sig_n = np.random.default_rng(seed_neutral).standard_normal(LATENT_SHAPE)
    sig_n -= np.sum(sig_n * sig) * sig
    sig_n /= np.linalg.norm(sig_n)
    return sig.astype(np.float32), sig_n.astype(np.float32)


def plant_concept(bundle, sig, sig_n) -> float:
    """Fit the base weights (LoRA off) so the concept's conditioning emits
    `sig` and the neutral one `sig_n`; -> the last loss."""
    import torch

    from leco_tpu_torch.lora import lora_mode

    unet, device = bundle.unet, bundle.device
    ctx_c = bundle.encode_fn(CONCEPT)
    ctx_n = bundle.encode_fn(NEUTRAL)
    s_c = torch.from_numpy(sig).to(device)
    s_n = torch.from_numpy(sig_n).to(device)
    lora = {id(p) for p in bundle.lora_params.values()}
    base = [p for p in unet.parameters() if id(p) not in lora]
    for p in base:
        p.requires_grad_(True)
    opt = torch.optim.Adam(base, lr=3e-3)
    gen = torch.Generator(device).manual_seed(7)
    b = 4
    with lora_mode(unet, "off"):
        for _ in range(PLANT_STEPS):
            x = torch.randn((b,) + LATENT_SHAPE[1:], generator=gen, device=device)
            t = torch.rand((b,), generator=gen, device=device) * 999.0
            out_c = unet(x, t, ctx_c.expand(b, -1, -1))
            out_n = unet(x, t, ctx_n.expand(b, -1, -1))
            loss = ((out_c - s_c) ** 2).mean() + ((out_n - s_n) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    for p in base:
        p.requires_grad_(False)
        p.grad = None
    return float(loss)


def main(argv=None) -> dict:
    import torch

    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.eval import erased_concept_delta
    from leco_tpu_torch.infer import applied_lora
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_random_bundle
    from leco_tpu_torch.train.trainer import train
    from leco_tpu_torch.train_lora import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; no fallback)")
    ap.add_argument("--out", default=None, help="save path of the run (default: a temp dir)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()

    # ---- 1. plant the concept
    bundle = make_random_bundle(device=device)
    sig, sig_n = signatures()
    overfit_loss = plant_concept(bundle, sig, sig_n)
    encode_fn = bundle.encode_fn  # train() frees it
    unet = bundle.unet

    # ---- 2. the real erase recipe through train()
    with tempfile.TemporaryDirectory() as tmp:
        config = RootConfig.from_dict({
            "prompts_file": "(in-code)",
            "pretrained_model": {"name_or_path": "random://tiny"},
            "network": {"rank": 4, "alpha": 1.0},
            "train": {"iterations": ITERATIONS, "max_denoising_steps": 3, "lr": 5e-3,
                      "seed": 0, "precision": "float32"},
            "save": {"name": "quality", "path": args.out or tmp, "per_steps": 0},
            "logging": {"use_wandb": False, "verbose": False},
        })
        prompts = [PromptSettings.from_dict({
            "target": CONCEPT, "unconditional": NEUTRAL, "action": "erase",
            "guidance_scale": 1.0, "resolution": 64, "batch_size": 1})]
        result = train(config, prompts, bundle)
    lora = result["lora"]

    # ---- 3. the real eval path with a signature scorer
    class SigScorer:
        def score(self, images, texts):
            return np.asarray([_cos(img, sig) for img in np.asarray(images)])

    @torch.no_grad()
    def unet_at(multiplier, x, t, ctx):
        with applied_lora(unet, lora, multiplier):
            return unet(x, t, ctx).float().cpu().numpy()

    def noise(seed):
        return torch.randn(LATENT_SHAPE, generator=torch.Generator(device).manual_seed(seed),
                           device=device)

    def generate_fn(prompt, seed, multiplier):
        return unet_at(multiplier, noise(seed), 500.0, encode_fn(prompt))

    out = erased_concept_delta(SigScorer(), decode_fn=lambda latents: latents,
                               generate_fn=generate_fn, concept=CONCEPT, seeds=(0, 1, 2, 3))

    # the A/B at -1/0/+1 for the record (the enhance side)
    ctx_c = encode_fn(CONCEPT)
    gen = torch.Generator(device).manual_seed(100)
    draws = [(torch.randn(LATENT_SHAPE, generator=gen, device=device),
              float(torch.rand((), generator=gen, device=device)) * 999.0) for _ in range(4)]
    sims = {str(m): float(np.mean([_cos(unet_at(m, x, t, ctx_c), sig) for x, t in draws]))
            for m in (-1.0, 0.0, 1.0)}

    record = {
        "metric": ("synthetic erased-concept signature delta (planted-concept protocol, "
                   "tiny UNet, the port's train() erase recipe)"),
        "value": out["delta"],
        "unit": "cosine-correlation drop (multiplier 0 -> +1)",
        "vs_baseline": out["delta"] / DELTA_BAR,
        "bar": DELTA_BAR,
        "bar_met": out["delta"] >= DELTA_BAR,
        "base_score": out["base"],
        "erased_score": out["erased"],
        "sims_at_multiplier": sims,
        "overfit_loss": overfit_loss,
        "train_losses_first10_mean": float(np.mean(result["losses"][:10])),
        "train_losses_last10_mean": float(np.mean(result["losses"][-10:])),
        "wall_s": time.perf_counter() - t0,
        "device": str(device),
        "kind": "quality",
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
