"""SDXL training throughput: LoRA train iterations/sec at 1024 px, bf16.

    python -m leco_tpu_torch.scripts.bench_xl [--device cuda|cpu]

Counterpart of `scripts/bench_xl.py`: the random full-width SDXL bundle
(`testing.make_sdxl_bundle`, the 2.57B UNet), 1024 px, batch 1, bf16,
rank-4 LoRA, DDIM, AdamW at a constant 1e-4 (the train_lora_xl recipe),
timed by `leco_tpu_torch.bench`'s protocol: one warm-up iteration at
timesteps_to 25, then the seeded sample (6 draws on CUDA, 2 on the CPU)
per_iter and deferred. LECO_BENCH_RES (default 1024) and LECO_BENCH_ATTN
are read as the JAX script reads them. `--device` defaults to cuda and
raises without a GPU. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def metric(res: int) -> str:
    return f"SDXL LoRA train iters/sec/chip, {res}px bf16 rank4 ddim"


def main(argv=None, bundle=None) -> dict:
    """Run the bench and print its JSON line; returns the record. `bundle`
    replaces the random full-width SDXL bundle (the tests pass a tiny one)."""
    from leco_tpu_torch.bench import flop_rates, stage_printer, time_train_steps, ttfi_fields
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.testing import make_sdxl_bundle
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = int(os.environ.get("LECO_BENCH_RES", "1024"))
    attn = os.environ.get("LECO_BENCH_ATTN", default_backend(device))
    t0 = time.perf_counter()
    stage = stage_printer("bench-xl", t0)
    stage(f"platform={benchkit.platform(device)} attn={attn} res={res}")

    if bundle is None:
        bundle = make_sdxl_bundle(spec=LoRASpec(rank=4, alpha=1.0), attn_backend=attn,
                                  device=device)
        stage("bundle built (SDXL 2.6B)")
    bundle.unet.set_attention_backend(attn)

    n_iters = 6 if device.type == "cuda" else 2
    timed = time_train_steps(bundle, res, 1, n_iters, stage)
    result = {
        "metric": metric(res),
        "value": round(n_iters / timed["deferred_s"], 4),
        "unit": "it/s",
        "platform": benchkit.platform(device),
        "attn": attn,
        "sync": "deferred_fetch_all",
        "per_iter_its_per_sec": round(n_iters / timed["per_iter_s"], 4),
        "mean_inner_steps": float(np.mean(timed["timesteps_to"])),
        **ttfi_fields(timed, t0),
        "knobs": benchkit.knobs(),
        "device": benchkit.device_record() if device.type == "cuda" else None,
        **flop_rates(bundle, res, 1, timed),
        "timesteps_to": timed["timesteps_to"],
        "losses": timed["losses"],
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
