#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`leco_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on a line of its own:
  1. device  — the card, and `nvidia-smi`'s name and power limit;
  2. build   — nvcc builds the flash-attention kernels from
               leco_tpu_torch/kernels/csrc (sm_90a);
  3. kernels — each kernel against its plain PyTorch version in bf16 at the
               training path's shapes, with times;
  4. unet    — one full-width SD1.5 forward through the kernels against the
               same forward through plain attention;
  5. profile — one train step under torch.profiler (device busy share, the
               kernels that take the time), and the step's time with the
               kernels against plain attention;
  6. train   — three iterations of `leco_tpu_torch.train.trainer.train()` on a
               random full-width SD1.5 bundle (bf16, rank-4 lierla, DDIM,
               512 px, batch 1, the van-gogh erase prompt), with the kernels'
               launch counts checked against the schedule.
Then a JSON line with every kernel's launches, error and times, and as the
last line {"ok": true, "device": {...}}. Any failure raises: the script then
exits non-zero and prints no result. It needs CUDA and the rest of the repo.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (BH, Nq, Nk, D) with BH = B * 8 heads: the SD1.5 self-attention shapes at
# 512 px (levels 0, 1, 2) at the inner loop's B = 2, the references' B = 3
# (level 0) and the differentiated target's B = 1, the one batch whose
# backward runs; then one SD2.1 head dim and a masked key count (Nk = 77)
KERNEL_SHAPES = [
    (16, 4096, 4096, 40),
    (24, 4096, 4096, 40),
    (8, 4096, 4096, 40),
    (16, 1024, 1024, 80),
    (8, 1024, 1024, 80),
    (16, 256, 256, 160),
    (8, 256, 256, 160),
    (16, 1024, 1024, 64),
    (16, 256, 77, 40),
]
# the level-0 shape at which each kernel runs most on the training path
TIMED_SHAPE = {
    "attn_fwd": (16, 4096, 4096, 40),
    "attn_bwd_dq": (8, 4096, 4096, 40),
    "attn_bwd_dkv": (8, 4096, 4096, 40),
}
# O: bf16 outputs and a reassociating online softmax — the bf16 bound of
# tests/test_flash_attention.py; LSE is fp32; gradients relative to their size
ATOL_O = 2e-2
ATOL_LSE = 1e-3
RTOL_GRAD = 2e-2
# the whole UNet through the kernels vs through plain attention, bf16:
# relative to the output's largest magnitude
RTOL_UNET = 5e-2
FLASH_ATTENTIONS_PER_FORWARD = 15  # SD1.5 at 512 px: 6 down + 9 up blocks
KERNELS = {
    "attn_fwd": ("leco_tpu_torch/kernels/csrc/flash_fwd.cu",
                 "leco_tpu/ops/flash_attention.py:69"),
    "attn_bwd_dq": ("leco_tpu_torch/kernels/csrc/flash_bwd_dq.cu",
                    "leco_tpu/ops/flash_attention.py:208"),
    "attn_bwd_dkv": ("leco_tpu_torch/kernels/csrc/flash_bwd_dkv.cu",
                     "leco_tpu/ops/flash_attention.py:234"),
}


def phase(name: str, result: dict) -> None:
    print(f"phase {name}: {json.dumps(result)}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median of CUDA-event timings of single calls, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": smi,
    }


def phase_build() -> dict:
    from leco_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    return {"seconds": seconds, "library": str(build.build()), "ptxas_lines": len(ptxas)}


def phase_kernels(device) -> dict:
    import torch

    from leco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device)
    gen.manual_seed(0)
    worst = {name: 0.0 for name in KERNELS}
    timed = {}
    for bh, nq, nk, d in KERNEL_SHAPES:
        def rand(n):
            return torch.randn((bh, n, d), generator=gen, device=device).to(torch.bfloat16)

        q, k, v, g = rand(nq), rand(nk), rand(nk), rand(nq)
        scale = d**-0.5
        o, lse = fa.attn_fwd(q, k, v, scale)
        o_ref, lse_ref = fa.attn_fwd_plain(q, k, v, scale)
        delta = (g.float() * o_ref.float()).sum(-1)
        dq = fa.attn_bwd_dq(q, k, v, g, lse_ref, delta, scale)
        dq_ref = fa.attn_bwd_dq_plain(q, k, v, g, lse_ref, delta, scale)
        dk, dv = fa.attn_bwd_dkv(q, k, v, g, lse_ref, delta, scale)
        dk_ref, dv_ref = fa.attn_bwd_dkv_plain(q, k, v, g, lse_ref, delta, scale)
        torch.cuda.synchronize()

        def err(a, b):
            return (a.float() - b.float()).abs().max().item()

        def size(a):
            return a.float().abs().max().item()

        e = {
            "o": err(o, o_ref), "lse": err(lse, lse_ref),
            "dq": err(dq, dq_ref), "dk": err(dk, dk_ref), "dv": err(dv, dv_ref),
        }
        check(e["o"] <= ATOL_O, f"O error {e['o']} > {ATOL_O} at {(bh, nq, nk, d)}")
        check(e["lse"] <= ATOL_LSE, f"LSE error {e['lse']} > {ATOL_LSE} at {(bh, nq, nk, d)}")
        for key, ref in (("dq", dq_ref), ("dk", dk_ref), ("dv", dv_ref)):
            check(e[key] <= RTOL_GRAD * size(ref),
                  f"{key} error {e[key]} > {RTOL_GRAD} x {size(ref)} at {(bh, nq, nk, d)}")
        worst["attn_fwd"] = max(worst["attn_fwd"], e["o"], e["lse"])
        worst["attn_bwd_dq"] = max(worst["attn_bwd_dq"], e["dq"])
        worst["attn_bwd_dkv"] = max(worst["attn_bwd_dkv"], e["dk"], e["dv"])

        ms = {
            "attn_fwd": (time_ms(lambda: fa.attn_fwd(q, k, v, scale)),
                         time_ms(lambda: fa.attn_fwd_plain(q, k, v, scale))),
            "attn_bwd_dq": (
                time_ms(lambda: fa.attn_bwd_dq(q, k, v, g, lse_ref, delta, scale)),
                time_ms(lambda: fa.attn_bwd_dq_plain(q, k, v, g, lse_ref, delta, scale))),
            "attn_bwd_dkv": (
                time_ms(lambda: fa.attn_bwd_dkv(q, k, v, g, lse_ref, delta, scale)),
                time_ms(lambda: fa.attn_bwd_dkv_plain(q, k, v, g, lse_ref, delta, scale))),
        }
        for name, shape in TIMED_SHAPE.items():
            if (bh, nq, nk, d) == shape:
                timed[name] = ms[name]
        print(json.dumps({"shape": [bh, nq, nk, d], "max_abs_err": e,
                          "ms": {n: t[0] for n, t in ms.items()},
                          "plain_ms": {n: t[1] for n, t in ms.items()}}), flush=True)
        del q, k, v, g, o, o_ref, dq, dq_ref, dk, dk_ref, dv, dv_ref
        torch.cuda.empty_cache()
    return {"worst_abs_err": worst, "timed_shapes": TIMED_SHAPE, "timed_ms": timed}


def phase_unet(bundle, device) -> dict:
    import torch

    gen = torch.Generator(device)
    gen.manual_seed(1)
    # 256 px: level 0 has 1024 tokens (flash), cross-attention stays plain
    x = torch.randn((2, 4, 32, 32), generator=gen, device=device)
    ctx = torch.randn((2, 77, 768), generator=gen, device=device)
    unet = bundle.unet
    with torch.no_grad():
        unet.set_attention_backend("flash")
        out = unet(x, 501.0, ctx).float()
        unet.set_attention_backend("xla")
        ref = unet(x, 501.0, ctx).float()
        unet.set_attention_backend("flash")
    err = (out - ref).abs().max().item()
    size = ref.abs().max().item()
    check(bool(torch.isfinite(out).all()), "non-finite UNet output")
    check(tuple(out.shape) == (2, 4, 32, 32), f"UNet output shape {tuple(out.shape)}")
    check(err <= RTOL_UNET * size, f"UNet flash vs plain {err} > {RTOL_UNET} x {size}")
    return {"max_abs_err": err, "max_abs_ref": size, "shape": list(out.shape)}


def phase_profile(bundle, device, timesteps_to: int = 10) -> dict:
    """One train step (t_to inner forwards + the 3B references + the
    differentiated target) under torch.profiler: the device's busy share and
    the kernels that take its time. Then the same step with the kernels and
    with plain attention, in turns (flash, plain, plain, flash)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train import trainer
    from leco_tpu_torch.train.optim import get_optimizer

    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": 512})
    pack = trainer.build_pack(trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0])
    opt = get_optimizer("adamw", list(bundle.lora_params.values()), 1e-4)
    step = trainer.make_train_step(bundle, opt, 50)
    gen = torch.Generator(device)
    gen.manual_seed(0)

    def run():
        t0 = time.perf_counter()
        step(pack, 1.0, 1.0, timesteps_to, height=512, width=512, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for backend in ("xla", "flash"):  # warm-up: cuDNN/cuBLAS pick algorithms
        bundle.unet.set_attention_backend(backend)
        run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    # device-side events only: the kernels (an op's row would count its
    # kernels' time a second time)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    flash_us = sum(e.self_device_time_total for e in kernels if "leco::flash_" in e.key)

    walls = {"flash": [], "plain": []}
    for backend in ("flash", "plain", "plain", "flash"):
        bundle.unet.set_attention_backend("flash" if backend == "flash" else "xla")
        walls[backend].append(run())
    bundle.unet.set_attention_backend("flash")
    return {
        "timesteps_to": timesteps_to,
        "wall_s_under_profiler": wall,
        "device_busy_s": busy_us / 1e6,
        # against the unprofiled step: the profiler slows the host down
        "device_idle_share": 1.0 - busy_us / 1e6 / min(walls["flash"]),
        "flash_kernels_share_of_busy": flash_us / busy_us,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top],
        "step_s_flash_vs_plain_attention": walls,
    }


def phase_train(bundle, out_dir: Path) -> dict:
    import torch

    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.lora import count_lora_modules, read_safetensors
    from leco_tpu_torch.ops import flash_attention as fa
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train.trainer import train
    from leco_tpu_torch.utils.debug import check_frozen_params, check_trainable_params

    iterations = 3
    # per_steps 1: with 3 iterations, a save every 2 steps would fall on the
    # last iteration, which the loop leaves to the final save
    config = RootConfig.from_dict({
        "prompts_file": "(in-code)",
        "pretrained_model": {"name_or_path": "(random sd15 bundle)"},
        "network": {"type": "lierla", "rank": 4, "alpha": 1.0,
                    "training_method": "full"},
        "train": {"precision": "bfloat16", "noise_scheduler": "ddim",
                  "iterations": iterations, "lr": 1e-4, "optimizer": "AdamW",
                  "lr_scheduler": "constant", "max_denoising_steps": 50,
                  "seed": 0},
        "save": {"name": "van_gogh", "path": str(out_dir), "per_steps": 1,
                 "precision": "bfloat16"},
        "logging": {"use_wandb": False, "verbose": False, "interval": 1},
    })
    prompts = [PromptSettings.from_dict({
        "target": "van gogh", "positive": "van gogh", "unconditional": "",
        "neutral": "", "action": "erase", "guidance_scale": 1.0,
        "resolution": 512, "dynamic_resolution": False, "batch_size": 1,
    })]
    before = {k: v.detach().clone() for k, v in bundle.lora_params.items()}
    trainable = check_trainable_params(bundle.unet)  # as train_lora.py does
    check_frozen_params(bundle.unet)
    stamps = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    result = train(config, prompts, bundle,
                   on_step=lambda i, loss: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()

    losses = result["losses"]
    check(len(losses) == iterations, f"{len(losses)} losses")
    check(all(torch.isfinite(torch.tensor(losses)).tolist()), f"losses {losses}")
    records = [json.loads(ln) for ln in (out_dir / "metrics.jsonl").read_text().splitlines()]
    check(len(records) == iterations, f"metrics.jsonl has {len(records)} lines")
    tsto = [r["timesteps_to"] for r in records]
    want = {
        "attn_fwd": FLASH_ATTENTIONS_PER_FORWARD * sum(t + 2 for t in tsto),
        "attn_bwd_dq": FLASH_ATTENTIONS_PER_FORWARD * iterations,
        "attn_bwd_dkv": FLASH_ATTENTIONS_PER_FORWARD * iterations,
    }
    check(launches == want, f"launches {launches} != {want}")

    last = out_dir / "van_gogh_last.safetensors"
    periodic = out_dir / "van_gogh_1steps.safetensors"
    check(last.exists() and periodic.exists(), "saves missing")
    state, metadata = read_safetensors(last)
    read_safetensors(periodic)
    n_layers = count_lora_modules(result["lora"])
    check(trainable["lora layers"] == n_layers, f"{trainable} vs {n_layers} layers")
    check(len(state) == 3 * n_layers, f"{len(state)} tensors for {n_layers} layers")
    for k, v in result["lora"].items():
        layer, part = k.rsplit(".", 1)
        key = "lora_unet_" + layer.replace(".", "_") + f".{part}.weight"
        check(torch.equal(state[key], v.to(torch.bfloat16)), f"saved {key} differs")
    check("config" in metadata, "metadata")
    changed = sum(not torch.equal(before[k].cpu(), v) for k, v in result["lora"].items())
    check(changed > 0, "no LoRA weight changed")

    per_iter = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print(f"train seconds per iteration: {json.dumps(per_iter)} "
          f"(timesteps_to {tsto})", flush=True)
    return {"losses": losses, "timesteps_to": tsto, "launches": launches,
            "seconds": seconds, "seconds_per_iteration": per_iter,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "lora_layers": n_layers, "lora_tensors_changed": changed}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU")
    sys.path.insert(0, str(REPO))
    from leco_tpu_torch.testing import make_sd15_bundle

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase("device", dev)
    phase("build", phase_build())
    kernels = phase_kernels(device)
    phase("kernels", kernels)

    t0 = time.perf_counter()
    bundle = make_sd15_bundle(dtype=torch.bfloat16, seed=0, device=device)
    check(bundle.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.backend
          == "flash", "the CUDA bundle does not default to the kernels")
    torch.cuda.synchronize()
    print(f"bundle built in {time.perf_counter() - t0:.1f} s", flush=True)
    phase("unet", phase_unet(bundle, device))
    phase("profile", phase_profile(bundle, device))
    with tempfile.TemporaryDirectory() as tmp:
        train_result = phase_train(bundle, Path(tmp))
    phase("train", train_result)

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": train_result["launches"][name],
            "max_abs_err": kernels["worst_abs_err"][name],
            "ms": kernels["timed_ms"][name][0],
            "plain_ms": kernels["timed_ms"][name][1],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
