"""The north-star measurement, run for real: one full 500-iteration
van-gogh-erase run through the port's real `train()` loop, recorded end to
end.

    python -m leco_tpu_torch.scripts.bench_full [--device cuda|cpu]

Counterpart of `scripts/bench_full.py`: the examples/config.yaml recipe,
SD1.5-shaped (rank 4 / alpha 1.0 lierla-full, DDIM, bf16, lr 1e-4 AdamW
constant, max_denoising_steps 50, saves every 200 steps in bf16, seed 0,
logging.interval 8) on the random-weight SD1.5 bundle, through the real
host loop (periodic saves, metrics.jsonl, the batched loss drain, the pack
cache, the seeded sampling). The record holds what a 12-iteration window
cannot see: total wall clock from the start to the final save written, the
time to the first fetched loss, per-100-iteration it/s, peak device memory
(`torch.cuda.max_memory_allocated` / `max_memory_reserved`), the saves and
the metrics.jsonl lines written. XLA's compile and cache counters have no
counterpart; the kernels' build takes their place (`kernels_built_now`,
`kernel_build_s`).

Environment, as the JAX script reads it:
  LECO_FULL_BATCH  logical batch size (default 1)
  LECO_FULL_ITERS  iteration count (default 500)
  LECO_FULL_CHUNK  train.step_chunk; > 1 is refused, as the trainer refuses
                   it (the JAX package's device-side scan, not ported)
  LECO_FULL_TINY=1 the tiny test UNet at 64 px (checks the instrumentation
                   on the CPU: `--device cpu`)
  LECO_FULL_OUT    save directory (default leco_full_run_b<batch> in the
                   temp directory; it persists across runs)
`--device` defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import torch

BASELINE_500_ITER_S = 500 / 0.083  # reference Colab pace over 500 iters


def memory_record(device: torch.device) -> dict:
    """Peak device memory of the run, or the reason there is none."""
    if device.type != "cuda":
        return {"memory_stats": {}, "memory_stats_note": "CPU run: no device allocator"}
    return {"memory_stats": {
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "max_memory_reserved": torch.cuda.max_memory_reserved(device),
        "total_memory": torch.cuda.get_device_properties(device).total_memory,
    }}


def main(argv=None) -> dict:
    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.models.unet import sd15_config, tiny_unet_config
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_random_bundle
    from leco_tpu_torch.train.trainer import _refuse_unported, train
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_devices = time.perf_counter() - t0

    def stage(msg):
        print(f"[full +{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    batch = int(os.environ.get("LECO_FULL_BATCH", "1"))
    iterations = int(os.environ.get("LECO_FULL_ITERS", "500"))
    step_chunk = int(os.environ.get("LECO_FULL_CHUNK", "1"))
    tiny = os.environ.get("LECO_FULL_TINY", "0") == "1"
    res = 64 if tiny else 512
    platform = benchkit.platform(device)
    stage(f"platform={platform} batch={batch} iterations={iterations} tiny={tiny}")

    out_dir = os.environ.get("LECO_FULL_OUT",
                             os.path.join(tempfile.gettempdir(), f"leco_full_run_b{batch}"))
    config = RootConfig.from_dict({
        "prompts_file": "(in-code)",
        "pretrained_model": {"name_or_path": "(random sd15 bundle)"},
        "network": {"type": "lierla", "rank": 4, "alpha": 1.0, "training_method": "full"},
        "train": {
            "precision": "bfloat16", "noise_scheduler": "ddim", "iterations": iterations,
            "lr": 1e-4, "optimizer": "AdamW", "lr_scheduler": "constant",
            "max_denoising_steps": 50, "seed": 0, "step_chunk": step_chunk,
        },
        "save": {"name": "van_gogh", "path": out_dir, "per_steps": 200,
                 "precision": "bfloat16"},
        "logging": {"use_wandb": False, "verbose": False, "interval": 8},
    })
    _refuse_unported(config)  # before the bundle is built
    prompts = [PromptSettings.from_dict({
        "target": "van gogh", "positive": "van gogh", "unconditional": "", "neutral": "",
        "action": "erase", "guidance_scale": 1.0, "resolution": res,
        "dynamic_resolution": False, "batch_size": batch,
    })]
    bundle = make_random_bundle(
        config=tiny_unet_config() if tiny else sd15_config(),
        spec=LoRASpec(rank=4, alpha=1.0), scheduler_kind="ddim",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        attn_backend="xla" if tiny else default_backend(device), device=device)
    t_built = time.perf_counter() - t0
    stage("bundle built")
    kernels_built_now, kernel_build_s = benchkit.kernel_library(device)

    metrics_path = os.path.join(out_dir, "metrics.jsonl")

    def metrics_lines() -> int:
        try:
            with open(metrics_path) as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    metrics_before = metrics_lines()  # out_dir persists across runs
    step_times: list[tuple[int, float]] = []  # (iteration, wall time drained)

    def on_step(i, loss_val):
        step_times.append((i, time.perf_counter()))

    t_train0 = time.perf_counter()
    result = train(config, prompts, bundle, on_step=on_step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    total_s = t_end - t0
    train_s = t_end - t_train0

    # per-100-iteration throughput from the drained-loss timestamps (the
    # drain lags dispatch by logging.interval, alike at both window edges)
    ttfi = step_times[0][1] - t0 if step_times else float("nan")
    per100 = []
    prev_i, prev_t = step_times[0]
    for i, t in step_times[1:]:
        if i - prev_i >= 100 or i == iterations - 1:
            per100.append(round((i - prev_i) / (t - prev_t), 4))
            prev_i, prev_t = i, t
    steady_its = ((step_times[-1][0] - step_times[0][0])
                  / (step_times[-1][1] - step_times[0][1])
                  if len(step_times) > 1 else float("nan"))

    losses = result["losses"]
    record = {
        "metric": (
            f"500-iteration van-gogh erase wall-clock, SD1.5 {res}px bf16 "
            f"rank4 ddim batch{batch} (REAL train() loop, end-to-end)"
        ),
        "value": round(total_s, 1),
        "unit": "s",
        # reference pace: 100 steps / 20 min -> 6024 s for 500 (BASELINE.md)
        "vs_baseline": round(BASELINE_500_ITER_S / total_s, 2),
        "platform": platform,
        "iterations": iterations,
        "batch": batch,
        "step_chunk": step_chunk,
        "train_loop_s": round(train_s, 1),
        "device_init_s": round(t_devices, 1),
        "bundle_build_s": round(t_built, 1),
        "time_to_first_fetched_loss_s": round(ttfi, 1),
        "steady_state_its_per_sec": round(steady_its, 4),
        "per_100_iter_its_per_sec": per100,
        "kernels_built_now": kernels_built_now,
        "kernel_build_s": round(kernel_build_s, 1),
        **memory_record(device),
        "losses_finite": all(math.isfinite(v) for v in losses),
        "n_losses": len(losses),
        "loss_first10_mean": round(sum(losses[:10]) / max(1, len(losses[:10])), 6),
        "loss_last10_mean": round(sum(losses[-10:]) / max(1, len(losses[-10:])), 6),
        "saves_written": [os.path.basename(str(p)) for p in result["saved"]],
        "metrics_jsonl_lines": metrics_lines() - metrics_before,
        "knobs": benchkit.knobs(),
        "device": benchkit.device_record() if device.type == "cuda" else None,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
