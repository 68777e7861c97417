#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`leco_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on a line of its own:
  1. device  — the card, and `nvidia-smi`'s name and power limit;
  2. build   — nvcc builds every kernel from leco_tpu_torch/kernels/csrc
               (sm_90a), one process per source;
  3. kernels — each flash-attention kernel against its plain PyTorch version
               in bf16 at the training path's shapes (SD1.5 and SD2.1), each
               error limit beside a control that must fail it (the plain
               version without a key tile, or for dk and dv without a query
               tile), with times of the kernel, its plain version and
               F.scaled_dot_product_attention (the library's call, which the
               port never makes; its backward at both level-0 target
               shapes), and each shape's roofline bound; every time twice:
               `ms` by CUDA events around 10 back-to-back calls (the
               wrapper's host time counts, as in the earlier runs) and
               `device_ms`, the device's own time per call from
               torch.profiler (`leco_tpu_torch/kernels/timing.py`); the
               packed-layout forward (LECO_FLASH_PACKED=1) at the SD2.1 and
               SD1.5 512 px self-attention shapes and a masked ragged key
               count, timed the same way and against the 3-d route with its
               head transposes;
  4. fused_kernels — the same for the fused configuration's kernels (3x3
               conv and its dx, GroupNorm-SiLU-conv, GroupNorm, GEGLU with
               and without the LoRA delta) at the SD1.5 512 px shapes (and
               the conv core at W 12, W 4 and a ragged Cin; conv3x3 also at
               every resnet conv the gnconv gate refuses on the knobs-on
               SD1.5 and SDXL paths, forward and dx), each limit
               beside a control that must fail it, with F.conv2d and
               F.group_norm as the library's calls (no single PyTorch call
               computes GroupNorm-SiLU-conv or GEGLU; F.conv2d on the
               activated input and F.linear(x, W, b) are timed beside them
               as the conv alone and the GEMM alone), and the conv core's
               weight repack, kernel against plain; the GroupNorm, bound by
               bytes, takes its device time rotating over enough input
               copies to exceed twice the L2;
  5. unet    — one full-width SD1.5 forward through the kernels against the
               same forward through plain attention;
  6. unet_fused — one full-width 512 px forward with the fused
               configuration's knobs on against the knobs off, with the
               per-forward launch count of every kernel;
  7. profile — one train step under torch.profiler, read by
               `leco_tpu_torch/scripts/profile_step.analyze` (device busy
               and idle share, the kernels that take the time, the time by
               category and by UNet component), and the step's time with the
               kernels against plain attention; then the same step with the
               knobs on, read the same way (each fused kernel's device time
               and share of it), and its time against the knobs off;
  8. train   — three iterations of `leco_tpu_torch.train.trainer.train()` on a
               random full-width SD1.5 bundle (bf16, rank-4 lierla, DDIM,
               512 px, batch 1, the van-gogh erase prompt), with every
               kernel's launch count checked against the schedule: once on
               the default path (knobs off: the flash kernels only), once
               with the knobs on (the seven kernels of that path: conv3x3
               on the resnet convs above 16 x 16, which the gnconv gate
               refuses, none on the upsamplers, which run phase
               convolutions), and once with the
               knobs on for a rank-4 c3lier LoRA (`train_fused_c3lier`: LoRA
               on every resnet and upsampler conv, so conv3x3 forward and dx,
               and no gnconv3x3; `fused_launches`);
     jax_knobs — (printed after train_fused) two of the JAX trainer's
               last runtime knobs on the lierla bundle: the train step's
               inner denoise at t_to 10 with the LoRA folded (the port's
               route) and on the literal LoRA branch (the JAX trainer's
               LECO_FOLD_INNER=0), a LoRA with seeded nonzero up weights,
               the same latents: the literal denoise within RTOL_UNET x
               max|ref| of the fold's, a LoRA-off control at least 3x past
               that, equal flash launches; the two routes in turns (fold,
               literal, literal, fold, twice): the denoise's ms by CUDA
               events, then the device busy time of a denoise step in each
               route and of the fold; one 512 px
               forward at batch 2 with the knobs on and
               LECO_GNCONV_KERNEL=0: gnconv3x3 launched 0 times, every
               resnet conv through the GroupNorm kernel and conv3x3, the
               output bitwise the forward's with LECO_RESNET_FUSED unset,
               and the forward's device time with and without the variable;
     bench   — (printed after train_fused_c3lier) the measurement entry
               points in process: `leco_tpu_torch.bench.main` knobs off
               (kernels 1-3) and with every knob on, LECO_FLASH_PACKED=1 too
               (kernels 4-8), each run's launches exactly what the warm-up
               and the seeded t_to sample imply, its one JSON line parsed
               (finite positive it/s, finite losses, 0 < mfu <= 1, the
               library not built again); `scripts/bench_full.main` cut to 20
               iterations (the record's fields, exact launches, the
               metrics.jsonl lines, the final save read back);
               `scripts/profile_unet.main` at 2 calls a timing (0 < MFU <= 1);
     scripts — (printed after bench) the last measurement scripts in process:
               `scripts/profile_fwd.main` four times (SD1.5 512 px batch 2
               knobs off, knobs on with LECO_FLASH_PACKED=1, SDXL 1024 px
               batch 2, and SD1.5 with --attn xla as the control without
               flash launches), each with its first output finite, exact
               launches a forward times the calls, device time, and the UNet
               components holding more than half of it;
               `scripts/bench_convs.main` (the three layouts, then
               --matmul), `scripts/bench_pallas_conv.main` (at every shape
               the kernel within RTOL_FUSED x max|ref| of F.conv2d and its
               flipped-tap control past that; conv3x3's launches equal to
               the calls it counted) and `scripts/ab_convfold.main` (SD and
               --xl: the fold's fp32 pin within its limit, its seamless
               control past it) at SCRIPTS_ITERS chained calls: every time
               finite and positive, every MFU in (0, 1];
  9. cli     — the repo's default recipe through the port's own entry point,
               `leco_tpu_torch.train_lora.main` (what `python -m
               leco_tpu_torch.train_lora --config_file ...` runs): a random
               full-width SD2.1 single-file checkpoint (fp16, LDM keys checked
               against tests/fixtures/ldm_unet_keys_sd21.txt) with a synthetic
               tokenizer beside it, examples/config.yaml (v2, v-prediction)
               with iterations 3, per_steps 1 and a temp save path, and
               examples/prompts.yaml as it is (512 px, batch 2); run with
               LECO_FLASH_PACKED unset (the 3-d flash kernels) and set to 1
               (the packed kernel), each with exact launch counts, finite
               losses and saves that read back equal; the default run with
               LECO_TRAIN_STAGES=1, its eight setup stages printed in order
               with times that never decrease (the packed run prints none);
 10. recipes — every SD1.x/2.x training option of the JAX trainer, cuDNN
               deterministic: examples/unreal_config.yaml and
               unreal_prompts.yaml (SD2.1, Lion, cosine, rank 16, 512/640/768
               px at batch 3/2/1) through `main()` on phase cli's file, 6
               iterations with save_state and ema_decay (losses finite, lr
               the float32 cosine's, exact launches, saves read back); the
               same run interrupted after iteration 3 and resumed from step_2
               (losses and weights within 1e-5 of the first run's, a control
               that must fail); ddpm, lms and euler_a through train() on the
               SD1.5 bundle; the eight optimizers on the unreal LoRA tree, card
               against CPU, with each step()'s device time; checkpoint_unet off
               and on at 768 px (equal loss, grads within 1e-2, one target
               forward's more forward launches, peak memory); the knobs
               LECO_FLASH_BWD=xla (no backward kernel, the kernels' grads) and
               LECO_FLASH_CROSS=1 (cross-attention through the forward kernel);
 11. infer   — inference and eval (`leco_tpu_torch.infer`, `.eval`) on phase
               cli's file and the LoRA its default run trained, bf16, 512 px,
               20 DDIM steps, guidance 7, cuDNN deterministic: the LoRA read
               by `load_lora_weights` (and from a copy with `.alpha` doubled
               and lora_up halved: the same tree); the A/B at -1/0/+1 with
               exact launch counts (multiplier 0 equal to no LoRA, -1 and +1
               not); the list form [(L, 0.5), (L, 0.5)] against L at 1.0 with
               a control; one generation with LECO_FLASH_PACKED=1; a random
               full-width VAE decoder and CLIP ViT-L/14 dual encoder
               (`decode_latents` to uint8 (1, 512, 512, 3), the CLIP score,
               `erased_concept_delta` over 2 seeds); seconds per DDIM step
               and per image, decode and score ms beside the card's name and
               power limit; and the phase-conv upsampler (the port's and
               the JAX package's four-conv form) against materialise +
               F.conv2d at SD1.5's three upsampler shapes;
 12. parallel — data, tensor and spatial parallelism (`leco_tpu_torch.parallel`):
               (printed right after phase kernels as phase kernels_sharded)
               kernels 1-3 at the shapes spatial parallelism hands them (SD1.5
               at 512 px, sp 2 and 4: the forward and dQ on N / sp query rows
               against all N keys, dK/dV on N / sp key rows against all N
               queries) against their plain versions under phase kernels'
               limits and controls, the level-0 shapes timed beside the plain
               version and SDPA; kernels 4-8 at the shapes the knobs-on meshes
               hand them (the convs' row windows, GroupNorm-SiLU-conv's with
               each edge row, the GroupNorm's statistics and apply launches,
               GEGLU at tp 2, the packed forward at sp 2 / 4 and tp 2), each
               against its plain version with a control, timed beside it and
               the library's call where one exists; then, after phase infer,
               one train step of the full-width SD1.5 bundle
               (bf16, 512 px) on each mesh, dp 2 at batch 2 and 1, sp 2, tp 2
               (2 ranks) and dp x sp 2 x 2 (4 ranks), and with every fused
               knob on (LECO_FLASH_PACKED too) sp 2, tp 2 (2 ranks), dp x sp
               2 x 2 and sp 4 (4 ranks), every rank on this card over gloo,
               against the unsharded step (knobs off or on) on the same
               weights and latents: the loss, the LoRA gradients at RTOL_GRAD
               x max|g| (four controls must fail it: the sp K/V gather
               replaced by the rank's own rows, the halo rows zeroed, the
               GroupNorm-SiLU-conv's padding rows through the activation, the
               GroupNorm kernel's statistics unreduced over sp), bitwise the
               same LoRA on every rank, each rank's launches of the eight
               kernels the unsharded step's, the 4-rank run's memory; then the
               default recipe through the CLI with a launcher's environment at
               world size 1 (NCCL). Times of ranks that share one card are no
               parallel speed;
 13. xl      — SDXL at full width, cuDNN deterministic: a random SDXL single
               file (fp16, 6.3 GiB, LDM keys checked against
               tests/fixtures/ldm_unet_keys_sdxl.txt) written one tensor at
               a time; examples/config_xl.yaml + prompts_xl.yaml (1024 px,
               batch 1, bf16, rank-4 lierla, DDIM, AdamW) through
               `train_lora_xl.main()`, 3 iterations with seed 0 (finite
               losses, exact flash launches, the save read back); one
               iteration each with dynamic_crops and with checkpoint_unet
               (peak memory); one 1024 px forward: kernels vs plain
               attention, the knobs on vs off (their launches at SDXL's
               shapes), packed bitwise the 3-d route; the trained LoRA's A/B
               at 1024 px, 20 DDIM steps, with exact launches, and a
               full-width SDXL VAE decode to uint8 (1, 1024, 1024, 3);
 14. ti      — textual-inversion erasure, cuDNN deterministic: a random
               full-width SD1.5 diffusers checkpoint (fp16, CLIP-L, the
               synthetic tokenizer); examples/ti_config.yaml +
               prompts.yaml (van gogh, 512 px, batch 2, bf16, DDIM, AdamW at
               lr 5e-3, seed 0) through `train_ti.main()`, 3 iterations with
               a save each (finite losses, exact flash launches: every
               self-attention but the first runs the backward pair, the
               embedding moved, every saved `emb_params` (2, 768) read back
               equal); one step's embedding gradient through the kernels
               against plain attention, also under LECO_FLASH_CROSS=1, each
               with a control, and checkpoint_unet on against off; the A/B at
               512 px, 20 DDIM steps (the identity splice bitwise the plain
               prompt, the trained embedding moving the latents); the native
               BPE engine loaded, its ids the Python merge loop's.
The knobs are the JAX package's: LECO_CONV_BACKEND=gemm, LECO_RESNET_FUSED=1,
LECO_TPU_FUSED_GN=1, LECO_GEGLU=fused, and LECO_FLASH_PACKED=1. Then a JSON
line with every kernel's launches, error, times (kernel, plain, library;
each as `ms` and `device_ms`) and roofline bound (`leco_tpu_torch/kernels/roofline.py`) at the shape where
the path runs it most, each kernel's launches on every parallel mesh, and
the four entries spatial parallelism adds (the row windows of kernels 5-6,
the split GroupNorm's two launches) at their sharded shapes, and as the last line
{"ok": true, "device": {...}}. Any failure raises: the script then exits
non-zero and prints no result. It needs CUDA and the rest of the repo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent

# (BH, Nq, Nk, D) with BH = B * 8 heads: the SD1.5 self-attention shapes at
# 512 px (levels 0, 1, 2) at the inner loop's B = 2, the references' B = 3
# (level 0) and the differentiated target's B = 1, the one batch whose
# backward runs; then a masked key count (Nk = 77), and SD1.5's level-0
# cross-attention over the 77 text tokens, which LECO_FLASH_CROSS=1 sends to
# the kernels (at the inner loop's B = 2 and the target's B = 1); then
# SD2.1's (every head 64 wide, heads 5 / 10 / 20) at the default recipe's
# batch 2: the inner loop's B = 4 at levels 0-2 and the target's B = 2 at
# level 0
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
    (16, 4096, 77, 40),
    (8, 4096, 77, 40),
    (20, 4096, 4096, 64),
    (10, 4096, 4096, 64),
    (40, 1024, 1024, 64),
    (80, 256, 256, 64),
    # SDXL at 1024 px (10 and 20 heads of 64): the references' 3B at levels 1
    # and 2, the target's B at level 2 (its inner 2B at both levels and its
    # target at level 1 are SD2.1's (20, 4096), (40, 1024) and (10, 4096))
    (30, 4096, 4096, 64),
    (60, 1024, 1024, 64),
    (20, 1024, 1024, 64),
]
# (B, Nq, Nk, C, heads) of the packed kernel: SD2.1 at 512 px (levels 0-2,
# heads 5 / 10 / 20, D 64) at the inner loop's B = 4 and the references'
# B = 6, level 0 at the target's B = 2; SD1.5's level 0 (8 heads, D 40); a
# ragged, masked key count
PACKED_SHAPES = [
    (4, 4096, 4096, 320, 5), (6, 4096, 4096, 320, 5), (2, 4096, 4096, 320, 5),
    (4, 1024, 1024, 640, 10), (6, 1024, 1024, 640, 10),
    (4, 256, 256, 1280, 20), (6, 256, 256, 1280, 20),
    (4, 4096, 4096, 320, 8),
    (4, 1024, 300, 640, 10),
    (2, 4096, 4096, 640, 10), (2, 1024, 1024, 1280, 20),  # SDXL's inner 2B at 1024 px
]
PACKED_TIMED = (4, 4096, 4096, 320, 5)  # SD2.1 level 0, the inner loop's batch
# the level-0 shape at which each kernel runs most on the training path
TIMED_SHAPE = {
    "attn_fwd": (16, 4096, 4096, 40),
    "attn_bwd_dq": (8, 4096, 4096, 40),
    "attn_bwd_dkv": (8, 4096, 4096, 40),
}
# O: bf16 outputs from a reassociating online softmax. The sound error is a
# bf16 ulp of the largest outputs (at most 2^-7 of max|ref|), so O is held to
# RTOL_O x max|ref| (2.5-5 ulps) and never above ATOL_O, the bf16 bound of
# tests/test_flash_attention.py. The control: the plain version without its
# last DROPPED_KEYS keys, what a kernel that loses a key tile computes, must
# fail that limit. LSE is fp32. Gradients: bf16 outputs of fp32 sums over
# bf16 dS (and P^T); the sound error is a bf16 ulp of the largest gradient
# (at most 2^-7 of max|ref|) plus what a flipped dS rounding moves, so dq,
# dk and dv are held to RTOL_GRAD x max|ref|. The controls, what a kernel
# that loses a tile computes, must fail it: dq over all keys but the last
# DROPPED_KEYS, dk and dv without the last DROPPED_QUERIES query rows (of q,
# dO, lse and delta)
ATOL_O = 2e-2
RTOL_O = 2e-2
DROPPED_KEYS = 64
DROPPED_QUERIES = 64
ATOL_LSE = 1e-3
RTOL_GRAD = 2e-2
# where one SDPA backward is timed beside the dq and dkv kernels: SD1.5's and
# SD2.1's level 0 at the target's batch (SD2.1's is SDXL's level 1 at B = 1),
# and SDXL's level 2 at B = 1
BWD_LIBRARY_SHAPES = ((8, 4096, 4096, 40), (10, 4096, 4096, 64), (20, 1024, 1024, 64))
# the whole UNet through the kernels vs through plain attention, bf16:
# relative to the output's largest magnitude
RTOL_UNET = 5e-2
# timing: calls back to back in each CUDA-event sample; seconds of matrix
# products before the first timing
TIME_REPS = 10
WARM_UP_SECONDS = 0.5
FLASH_ATTENTIONS_PER_FORWARD = 15  # SD1.5 and SD2.1 at 512 px: 6 down + 9 up blocks
KERNELS = {
    "attn_fwd": ("leco_tpu_torch/kernels/csrc/flash_fwd.cu",
                 "leco_tpu/ops/flash_attention.py:69"),
    "attn_bwd_dq": ("leco_tpu_torch/kernels/csrc/flash_bwd_dq.cu",
                    "leco_tpu/ops/flash_attention.py:208"),
    "attn_bwd_dkv": ("leco_tpu_torch/kernels/csrc/flash_bwd_dkv.cu",
                     "leco_tpu/ops/flash_attention.py:234"),
    "attn_fwd_packed": ("leco_tpu_torch/kernels/csrc/flash_fwd.cu",
                        "leco_tpu/ops/flash_attention.py:528"),
    "conv3x3": ("leco_tpu_torch/kernels/csrc/conv3x3.cu",
                "leco_tpu/ops/conv.py:66"),
    "gnconv3x3": ("leco_tpu_torch/kernels/csrc/conv3x3.cu",
                  "leco_tpu/ops/gn_conv.py:191"),
    "group_norm": ("leco_tpu_torch/kernels/csrc/group_norm.cu",
                   "leco_tpu/ops/group_norm.py:26"),
    "geglu": ("leco_tpu_torch/kernels/csrc/geglu.cu",
              "leco_tpu/ops/geglu.py:91"),
}
FLASH = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkv")
PACKED = "attn_fwd_packed"
FUSED = ("conv3x3", "gnconv3x3", "group_norm", "geglu")
# the JAX package's fused-kernel configuration
FUSED_KNOBS = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1",
               "LECO_TPU_FUSED_GN": "1", "LECO_GEGLU": "fused"}
# each fused kernel against its plain version, bf16 both: the error
# relative to the plain output's largest magnitude (both round fp32 sums to
# bf16 once; a bf16 ulp is 2^-8 of a value)
RTOL_FUSED = 1e-2
# Launches per UNet forward at SD1.5 512 px, rank-4 lierla, all knobs on
# (`fused_launches`): of the 44 resnet convs (none has a LoRA branch) the 24
# at 16 x 16 and below take gnconv3x3, the 20 above (`gn_conv.MAX_FUSED_SIDE`)
# the GroupNorm kernel and conv3x3, and 18 of those run conv3x3's dx on a
# target pass (all but the first resnet's two convs, before any LoRA); 16
# transformer norms plus conv_norm_out; 16 GEGLUs; the 3 upsamplers run as
# phase convolutions (no LoRA branch on them), as in the JAX package. A
# c3lier run keeps conv3x3 on every resnet and upsampler conv.
# SD1.5's UNet: resnet convs (gnconv3x3, refused, refused with dx),
# upsamplers, transformer blocks (one norm and one GEGLU each)
SD15_CONVS = (24, 20, 18)
SD15_UPSAMPLERS, SD15_TRANSFORMERS = 3, 16


def unet_convs(model: str, resolution: int) -> list:
    """(Cin, H, W, Cout, needs_dx) of every resnet 3x3 conv of one forward of
    "sd15" or "sdxl" at `resolution` px (`time_gates.resnet_convs`)."""
    from leco_tpu_torch.kernels.time_gates import resnet_convs
    from leco_tpu_torch.models.unet import sd15_config, sdxl_config

    config = {"sd15": sd15_config, "sdxl": sdxl_config}[model]()
    return resnet_convs(config, resolution, resolution)


def refused_convs(model: str, resolution: int) -> list:
    """`unet_convs` whose shape the gnconv gate refuses (bf16 on CUDA)."""
    import torch

    from leco_tpu_torch.ops import gn_conv

    return [c for c in unet_convs(model, resolution) if not gn_conv.supports(
        (1, c[0], c[1], c[2]), c[3], torch.bfloat16, torch.device("cuda"))]


def fused_launches(network: str, forwards: int, targets: int, convs=SD15_CONVS,
                   upsamplers: int = SD15_UPSAMPLERS,
                   transformers: int = SD15_TRANSFORMERS, blocks: Optional[int] = None) -> dict:
    """The fused kernels' launches in `forwards` UNet forwards with every
    knob on, `targets` of them the differentiated target pass with its
    backward; `convs` counts the model's resnet convs a forward as (through
    gnconv3x3, refused by its gate, refused and needing dx). lierla: a
    resnet conv the gnconv gate admits takes gnconv3x3 (its GroupNorm
    collapsed to an affine); one it refuses takes the GroupNorm kernel, then
    conv3x3, whose dx runs on the target pass where the conv's input needs a
    gradient; the upsamplers take no conv3x3. c3lier: gnconv3x3 fuses no
    conv the spec matches (the JAX package, models/unet.py:212-242), so
    every resnet conv takes conv3x3 after a GroupNorm kernel on every pass;
    the upsamplers take conv3x3 on the target pass only (with the LoRA
    branch on the 2x upsample is materialised; folded and off passes run the
    phase convolutions); the backward runs conv3x3 for the dx of every
    conv3x3 of the target pass but the first resnet's conv1, whose input
    (conv_in's output) needs no gradient. `transformers` counts the
    Transformer2DModels (one GroupNorm each), `blocks` their transformer
    blocks (one GEGLU each; by default one a model, as in SD1.x/2.x)."""
    blocks = transformers if blocks is None else blocks
    fused, refused, refused_dx = convs
    n = fused + refused
    if network == "lierla":
        return {"gnconv3x3": fused * forwards, "group_norm": (transformers + 1 + refused) * forwards,
                "geglu": blocks * forwards, "conv3x3": refused * forwards + refused_dx * targets}
    if network == "c3lier":
        return {"gnconv3x3": 0, "group_norm": (n + transformers + 1) * forwards,
                "geglu": blocks * forwards,
                "conv3x3": n * forwards + (upsamplers + n - 1 + upsamplers) * targets}
    raise ValueError(network)


def conv_path_shapes() -> tuple[list, list]:
    """(B, Cin, H, W, Cout) of conv3x3 on the lierla knobs-on paths, forward
    and dx: SD1.5's refused resnet convs at the inner loop's B 2 and the
    references' B 3, their dx at the target's B 1 (of the gradient's
    channels into the forward's input channels), SDXL's at B 2."""
    sd15 = refused_convs("sd15", SD15_RESOLUTION)
    forward = sorted({(b, cin, h, w, cout) for cin, h, w, cout, _ in sd15 for b in (2, 3)}
                     | {(2, cin, h, w, cout)
                        for cin, h, w, cout, _ in refused_convs("sdxl", XL_RESOLUTION)})
    dx = sorted({(1, cout, h, w, cin) for cin, h, w, cout, needs_dx in sd15 if needs_dx})
    return forward, dx


# (B, Cin, H, W, Cout): the upsampler convs at B = 2 (inner loop), the
# level-0 one at the references' B = 3; dx runs at the target's B = 1
CONV_SHAPES = [(2, 1280, 16, 16, 1280), (2, 1280, 32, 32, 1280), (2, 640, 64, 64, 640),
               (3, 640, 64, 64, 640),
               (2, 192, 16, 16, 320)]  # a ragged Cin (the gate takes any Cin >= 128)
CONV_DX_SHAPES = [(1, 1280, 16, 16, 1280), (1, 1280, 32, 32, 1280), (1, 640, 64, 64, 640)]
# every resnet conv shape of SD1.5 at 512 px, at B = 2; level 0 at B = 3, 1
GNCONV_SHAPES = [
    (2, 320, 64, 64, 320), (2, 960, 64, 64, 320), (2, 640, 64, 64, 320),
    (2, 320, 32, 32, 640), (2, 640, 32, 32, 640), (2, 1920, 32, 32, 640),
    (2, 1280, 32, 32, 640), (2, 960, 32, 32, 640), (2, 640, 16, 16, 1280),
    (2, 1280, 16, 16, 1280), (2, 2560, 16, 16, 1280), (2, 1920, 16, 16, 1280),
    (2, 1280, 8, 8, 1280), (2, 2560, 8, 8, 1280),
    (3, 320, 64, 64, 320), (1, 320, 64, 64, 320),
    # SD2.1's level 3 at 768 px (W 12) and the gate's smallest image (4 x 4):
    # W % 8 != 0, the kernel's fill route
    (2, 320, 12, 12, 320), (1, 128, 4, 4, 128),
]
# (B, C, H, W, eps, silu): the transformer norms and conv_norm_out
GN_SHAPES = [
    (2, 320, 64, 64, 1e-6, False), (2, 640, 32, 32, 1e-6, False),
    (2, 1280, 16, 16, 1e-6, False), (2, 1280, 8, 8, 1e-6, False),
    (2, 320, 64, 64, 1e-5, True), (3, 320, 64, 64, 1e-6, False),
    (1, 320, 64, 64, 1e-6, False),
]
# (M, K, N, r): the three GEGLU levels, B·tokens rows; the LoRA delta
# (rank 4) only in the differentiated target pass (B = 1)
GEGLU_SHAPES = [
    (2 * 4096, 320, 1280, 0), (2 * 1024, 640, 2560, 0), (2 * 256, 1280, 5120, 0),
    (3 * 4096, 320, 1280, 0), (4096, 320, 1280, 4), (1024, 640, 2560, 4),
    (256, 1280, 5120, 4), (2 * 4096, 320, 1280, 4),
]
# the most frequent shape on the path of each fused kernel, where it is timed
FUSED_TIMED = {
    "conv3x3": (2, 640, 64, 64, 640),
    "gnconv3x3": (2, 1280, 8, 8, 1280),
    "group_norm": (2, 320, 64, 64, 1e-6, False),
    "geglu": (2 * 4096, 320, 1280, 0),
}
# phase recipes: the unreal recipe cut to UNREAL_ITERATIONS iterations with a
# save (and a full-state snapshot) every UNREAL_PER_STEPS
UNREAL_ITERATIONS = 6
UNREAL_PER_STEPS = 2
UNREAL_EMA_DECAY = 0.999
# a resumed run against the uninterrupted one: the losses relative to each
# loss, the saved weights relative to their largest magnitude (the control,
# run 1's weights UNREAL_PER_STEPS iterations before the end, must fail it)
RTOL_RESUME = 1e-5
# the single steps of phase recipes (checkpoint_unet at SD2.1's largest
# unreal resolution, the knobs and the schedulers at SD1.5's 512 px)
STEP_TIMESTEPS_TO = 2
CKPT_RESOLUTION = 768
SD15_RESOLUTION = 512
# checkpoint_unet on against off: the LoRA grads relative to their largest
# magnitude (the control: the same step on other latents must fail it)
RTOL_CKPT_GRADS = 1e-2
# (name, lr, optimizer_args): the recipe's lr, lr 1 for the learning-rate-free
# ones with their first distance estimate at 1e-3 (1e-6 moves no weight in
# OPTIMIZER_STEPS steps); the card's weights are held to the CPU's within
# RTOL_OPTIMIZER x max|w| (the same float32 operations; the D-Adaptation
# sums in fp64 in other orders)
OPTIMIZERS = [("adamw", 1e-4, ""), ("adam", 1e-4, ""), ("lion", 1e-4, ""),
              ("prodigy", 1.0, "estim_lr0=1e-3"), ("dadaptadam", 1.0, "estim_lr0=1e-3"),
              ("dadaptlion", 1.0, "d0=1e-3"), ("adam8bit", 1e-4, ""), ("lion8bit", 1e-4, "")]
OPTIMIZER_STEPS = 5
RTOL_OPTIMIZER = 1e-5
SD21_CHECKPOINT = Path("sd21") / "v2-1_random.safetensors"
# phase infer: the README's A/B over AddNet weights at the generation
# defaults (512 px, 20 DDIM steps, guidance 7), bf16, with phase cli's LoRA
INFER_STEPS = 20
INFER_MULTIPLIERS = (-1.0, 0.0, 1.0)
INFER_PROMPT = "van gogh"
CLIP_SEEDS = (0, 1)
# the list form [(L, 0.5), (L, 0.5)] against the single form at 1.0: the
# two runs' distance within RTOL_COMPOSE of the LoRA's own effect (the
# single run's distance from the run without it); the control [(L, 0.5)]
# sits about half the effect away and must fail it. The CLI's LoRA (3
# iterations from lora_up = 0) moves no bf16 weight by an ulp when folded,
# so this check takes it scaled by a power of two until its fold moves the
# weights by COMPOSE_WEIGHT_SHARE of their RMS: an effect in the linear
# regime, where the control sits near half of it (a much larger share
# saturates the effect at the latents' own size)
RTOL_COMPOSE = 0.1
COMPOSE_WEIGHT_SHARE = 0.01
# SD1.5's upsampler convs (B, C, H) at the inner loop's batch: the port's
# phase convolutions (one conv of the four stacked 2x2 kernels), the JAX
# package's literal form (four convs, one per phase) and the materialised
# upsample + F.conv2d, bf16, each held to the fp32 conv of the materialised
# input within RTOL_FUSED
UPSAMPLER_SHAPES = [(2, 1280, 8), (2, 1280, 16), (2, 640, 32)]
# phase xl: examples/config_xl.yaml + prompts_xl.yaml (1024 px, batch 1) on a
# random full-width SDXL single file, cut to XL_ITERATIONS iterations
XL_CHECKPOINT = Path("sdxl") / "sdxl_random.safetensors"
XL_ITERATIONS = 3
XL_RESOLUTION = 1024
# SDXL at 1024 px: self-attention over 4096 tokens (level 1: 2 x 2 down, 3 x 2
# up) and 1024 (level 2: 2 x 10 down, 3 x 10 up, 10 in the mid block)
XL_FLASH_PER_FORWARD = 70
# SDXL's UNet at 1024 px: 34 resnet convs, all above 16 x 16 (none through
# gnconv3x3; 28 need dx), 2 upsamplers, 11 Transformer2DModels of 70 blocks
XL_CONVS = (0, 34, 28)
XL_UPSAMPLERS, XL_TRANSFORMERS = 2, 11
XL_INFER_STEPS = 20
XL_PROMPT = "van gogh"
# phase ti: examples/ti_config.yaml + prompts.yaml (SD1.5, van gogh, 512 px,
# batch 2) on a random full-width SD1.5 diffusers checkpoint, cut to
# TI_ITERATIONS iterations with a save every iteration; the A/B at the
# generation defaults (512 px, TI_INFER_STEPS DDIM steps)
TI_CHECKPOINT = Path("sd15") / "diffusers"
TI_ITERATIONS = 3
TI_INFER_STEPS = 20
TI_PROMPT = "van gogh"
# every self-attention but the first runs the backward pair on the target
# pass: the first one's inputs need no gradient (the trained embedding
# enters at the cross-attention after it)
TI_FLASH_BACKWARDS = FLASH_ATTENTIONS_PER_FORWARD - 1


def wrappers() -> dict:
    """Kernel name -> its wrapper, which counts its launches."""
    from leco_tpu_torch.ops import conv, geglu, gn_conv
    from leco_tpu_torch.ops import flash_attention as fa
    from leco_tpu_torch.ops import group_norm as gn

    return {"attn_fwd": fa.attn_fwd, "attn_bwd_dq": fa.attn_bwd_dq,
            "attn_bwd_dkv": fa.attn_bwd_dkv, PACKED: fa.attn_fwd_packed,
            "conv3x3": conv.conv3x3_gemm,
            "gnconv3x3": gn_conv.gnconv3x3, "group_norm": gn.group_norm_silu,
            "geglu": geglu.geglu_gemm}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def launches() -> dict[str, int]:
    return {name: w.launches for name, w in wrappers().items()}


@contextlib.contextmanager
def environ(values: dict):
    """Each variable of `values` set (None: unset) inside the block."""
    saved = {k: os.environ.get(k) for k in values}

    def apply(settings: dict) -> None:
        for k, v in settings.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    apply(values)
    try:
        yield
    finally:
        apply(saved)


def fused_knobs(on: bool):
    """The fused configuration's knobs set (or unset) inside the block."""
    return environ({k: v if on else None for k, v in FUSED_KNOBS.items()})


_PHASE_START = [time.perf_counter()]


def phase(name: str, result: dict) -> None:
    """Print a phase's result with the seconds since the previous phase."""
    now = time.perf_counter()
    result = {**result, "phase_seconds": now - _PHASE_START[0]}
    _PHASE_START[0] = now
    print(f"phase {name}: {json.dumps(result)}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_o(o, o_ref, o_dropped, shape) -> dict:
    """Hold O to min(ATOL_O, RTOL_O x max|ref|), and check that this limit
    fails the control `o_dropped` -> the error, the limit and the control's
    error."""
    ref = o_ref.float()
    limit = min(ATOL_O, RTOL_O * ref.abs().max().item())
    err = (o.float() - ref).abs().max().item()
    control = (o_dropped.float() - ref).abs().max().item()
    check(err <= limit, f"O error {err} > {limit} at {shape}")
    check(control > limit, f"the O limit {limit} passes the plain version without "
                           f"its last {DROPPED_KEYS} keys ({control}) at {shape}")
    return {"o": err, "o_limit": limit, "o_control": control}


def check_grads(got: dict, ref: dict, control: dict, shape) -> dict:
    """Hold dq, dk and dv to RTOL_GRAD x max|ref|, and check that each limit
    fails its control -> the errors, the limits and the controls' errors."""
    err, limit, control_err = {}, {}, {}
    for key in ("dq", "dk", "dv"):
        want = ref[key].float()
        limit[key] = RTOL_GRAD * want.abs().max().item()
        err[key] = (got[key].float() - want).abs().max().item()
        control_err[key] = (control[key].float() - want).abs().max().item()
        check(err[key] <= limit[key], f"{key} error {err[key]} > {limit[key]} at {shape}")
        check(control_err[key] > limit[key],
              f"the {key} limit {limit[key]} passes its control ({control_err[key]}) at {shape}")
    return {"err": err, "grad_limit": limit, "grad_control": control_err}


def time_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median of `iters` CUDA-event timings, after a warm-up, each of
    TIME_REPS calls back to back divided by TIME_REPS: the card's time per
    call, not the host's time to enqueue one call onto an idle card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIME_REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIME_REPS)
    return statistics.median(times)


TIME_KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
             "library_device_ms")


def kernel_times(kernel_fn, plain_fn, library_fn=None, rotated=None) -> dict:
    """A kernel's, its plain version's and the library's time per call, each
    two ways: `ms` by CUDA events around back-to-back calls (the wrapper's
    host time counts, as in every earlier run) and `device_ms`, the device's
    own time per call from torch.profiler (`kernels/timing.py`). `rotated`,
    for a row bound by bytes: (kernel, plain, library) lists of calls over
    enough input copies to exceed twice the L2, which `device_ms` cycles
    through instead, so that each call reads its input from device memory."""
    from leco_tpu_torch.kernels import timing

    fns = (kernel_fn, plain_fn, library_fn)
    dev_fns = rotated if rotated is not None else fns
    out = {}
    for prefix, fn, dev_fn in zip(("", "plain_", "library_"), fns, dev_fns):
        out[f"{prefix}ms"] = time_ms(fn) if fn else None
        out[f"{prefix}device_ms"] = timing.device_ms(dev_fn) if fn else None
    return out


def row_times(fns, bound: dict, rotate=None) -> dict:
    """`kernel_times` of (kernel, plain, library) `fns`; for a row bound by
    bytes, `rotate` = (input, fns_of), where fns_of(copy) gives the three
    calls on one copy of the input, and `device_ms` cycles over enough
    copies to exceed twice the L2, so that each call reads its input from
    device memory."""
    from leco_tpu_torch.kernels import timing

    if rotate is None or bound["bound_by"] != "bytes":
        return kernel_times(*fns)
    src, fns_of = rotate
    copies = [src.clone() for _ in range(timing.rotation_count(src.numel() * src.element_size()))]
    per_copy = [fns_of(c) for c in copies]
    return {**kernel_times(*fns, [[f[i] for f in per_copy] for i in range(3)]),
            "l2_rotation_copies": len(copies)}


def warm_up_clocks(device) -> None:
    """Keep the card busy for WARM_UP_SECONDS with bf16 matrix products, so
    that the first kernel timed does not catch its clocks on the way up."""
    import torch

    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_UP_SECONDS:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


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
    import torch.nn.functional as F

    from leco_tpu_torch.kernels import roofline, timing
    from leco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device)
    gen.manual_seed(0)
    warm_up_clocks(device)
    worst = {name: 0.0 for name in FLASH}
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

        o_dropped, _ = fa.attn_fwd_plain(q, k[:, :-DROPPED_KEYS], v[:, :-DROPPED_KEYS], scale)
        o_check = check_o(o, o_ref, o_dropped, (bh, nq, nk, d))
        dq_dropped = fa.attn_bwd_dq_plain(q, k[:, :-DROPPED_KEYS], v[:, :-DROPPED_KEYS], g,
                                          lse_ref, delta, scale)
        kept = slice(0, nq - DROPPED_QUERIES)
        dk_dropped, dv_dropped = fa.attn_bwd_dkv_plain(q[:, kept], k, v, g[:, kept],
                                                       lse_ref[:, kept], delta[:, kept], scale)
        grads = check_grads({"dq": dq, "dk": dk, "dv": dv},
                            {"dq": dq_ref, "dk": dk_ref, "dv": dv_ref},
                            {"dq": dq_dropped, "dk": dk_dropped, "dv": dv_dropped},
                            (bh, nq, nk, d))
        del dq_dropped, dk_dropped, dv_dropped
        e = {"o": o_check["o"], "lse": err(lse, lse_ref), **grads["err"]}
        check(e["lse"] <= ATOL_LSE, f"LSE error {e['lse']} > {ATOL_LSE} at {(bh, nq, nk, d)}")
        worst["attn_fwd"] = max(worst["attn_fwd"], e["o"], e["lse"])
        worst["attn_bwd_dq"] = max(worst["attn_bwd_dq"], e["dq"])
        worst["attn_bwd_dkv"] = max(worst["attn_bwd_dkv"], e["dk"], e["dv"])

        fns = {
            "attn_fwd": (lambda: fa.attn_fwd(q, k, v, scale),
                         lambda: fa.attn_fwd_plain(q, k, v, scale)),
            "attn_bwd_dq": (lambda: fa.attn_bwd_dq(q, k, v, g, lse_ref, delta, scale),
                            lambda: fa.attn_bwd_dq_plain(q, k, v, g, lse_ref, delta, scale)),
            "attn_bwd_dkv": (lambda: fa.attn_bwd_dkv(q, k, v, g, lse_ref, delta, scale),
                             lambda: fa.attn_bwd_dkv_plain(q, k, v, g, lse_ref, delta, scale)),
        }
        ms = {n: (time_ms(kernel), time_ms(plain)) for n, (kernel, plain) in fns.items()}
        # the library's forward, then the kernel's second turn
        q4, k4, v4 = q[None], k[None], v[None]
        library_fns = {"attn_fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)}
        library = {"attn_fwd": time_ms(library_fns["attn_fwd"])}
        fwd_second_turn = time_ms(lambda: fa.attn_fwd(q, k, v, scale))
        pair = {}
        if (bh, nq, nk, d) in BWD_LIBRARY_SHAPES:
            # one SDPA backward computes what the dq and dkv kernels compute together
            qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            library_fns["attn_bwd_dq"] = library_fns["attn_bwd_dkv"] = (
                lambda: torch.autograd.grad(out, (qg, kg, vg), g[None], retain_graph=True))
            library["attn_bwd_dq"] = library["attn_bwd_dkv"] = time_ms(
                library_fns["attn_bwd_dq"])
            pair = {"bwd_pair_ms": ms["attn_bwd_dq"][0] + ms["attn_bwd_dkv"][0]}
        # the device's own time of each call (no host time between launches)
        dev = {n: (timing.device_ms(kernel), timing.device_ms(plain))
               for n, (kernel, plain) in fns.items()}
        library_dev = {"attn_fwd": timing.device_ms(library_fns["attn_fwd"])}
        if "attn_bwd_dq" in library_fns:
            library_dev["attn_bwd_dq"] = library_dev["attn_bwd_dkv"] = timing.device_ms(
                library_fns["attn_bwd_dq"])
            pair["bwd_pair_device_ms"] = dev["attn_bwd_dq"][0] + dev["attn_bwd_dkv"][0]
            del qg, kg, vg, out
        del library_fns
        for name, shape in TIMED_SHAPE.items():
            if (bh, nq, nk, d) == shape:
                timed[name] = {"ms": ms[name][0], "plain_ms": ms[name][1],
                               "library_ms": library.get(name), "device_ms": dev[name][0],
                               "plain_device_ms": dev[name][1],
                               "library_device_ms": library_dev.get(name)}
        print(json.dumps({"shape": [bh, nq, nk, d], "max_abs_err": e,
                          "o_limit": o_check["o_limit"], "o_control": o_check["o_control"],
                          "grad_limit": grads["grad_limit"], "grad_control": grads["grad_control"],
                          "ms": {n: t[0] for n, t in ms.items()},
                          "plain_ms": {n: t[1] for n, t in ms.items()},
                          "library_ms": library,
                          "device_ms": {n: t[0] for n, t in dev.items()},
                          "plain_device_ms": {n: t[1] for n, t in dev.items()},
                          "library_device_ms": library_dev,
                          "attn_fwd_second_turn_ms": fwd_second_turn, **pair,
                          "bound_ms": {n: roofline.kernel_bound(n, (bh, nq, nk, d))["bound_ms"]
                                       for n in FLASH}}), flush=True)
        del q, k, v, g, o, o_ref, o_dropped, dq, dq_ref, dk, dk_ref, dv, dv_ref
        torch.cuda.empty_cache()
    worst[PACKED], timed[PACKED], route_3d_ms = packed_kernel_checks(device, gen)
    return {"worst_abs_err": worst, "timed_shapes": {**TIMED_SHAPE, PACKED: PACKED_TIMED},
            "timed_ms": timed, "packed_vs_3d_route_ms": {
                "packed_kernel": timed[PACKED]["ms"], "3d_route": route_3d_ms,
                "shape": PACKED_TIMED}}


def packed_kernel_checks(device, gen):
    """The packed forward against its plain version at PACKED_SHAPES ->
    (worst error, the times of the kernel, its plain version and the
    library at PACKED_TIMED, ms of the 3-d route at PACKED_TIMED: the head
    transposes into (B·H, N, D), the 3-d kernel, and the transpose back, as
    `ops/attention.py` runs it)."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from leco_tpu_torch.kernels import roofline, timing
    from leco_tpu_torch.ops import flash_attention as fa

    worst, timed, route_3d_ms = 0.0, None, None
    for b, nq, nk, c, heads in PACKED_SHAPES:
        def rand(n):
            return torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16)

        q, k, v = rand(nq), rand(nk), rand(nk)
        scale = (c // heads) ** -0.5
        o = fa.attn_fwd_packed(q, k, v, heads, scale)
        o_ref = fa.attn_fwd_packed_plain(q, k, v, heads, scale)
        torch.cuda.synchronize()
        shape = (b, nq, nk, c, heads)
        check(tuple(o.shape) == (b, nq, c) and bool(torch.isfinite(o.float()).all()),
              f"packed output {tuple(o.shape)} at {shape}")
        o_check = check_o(o, o_ref, fa.attn_fwd_packed_plain(
            q, k[:, :-DROPPED_KEYS], v[:, :-DROPPED_KEYS], heads, scale), shape)
        err = o_check.pop("o")
        worst = max(worst, err)
        q4, k4, v4 = (t.view(b, t.shape[1], heads, c // heads).transpose(1, 2)
                      for t in (q, k, v))
        row = {"kernel": PACKED, "shape": list(shape), "max_abs_err": err, **o_check,
               **kernel_times(lambda: fa.attn_fwd_packed(q, k, v, heads, scale),
                              lambda: fa.attn_fwd_packed_plain(q, k, v, heads, scale),
                              lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
               **roofline.kernel_bound(PACKED, shape)}
        if shape == PACKED_TIMED:
            def route_3d():
                q3, k3, v3 = (rearrange(t, "b n (h d) -> (b h) n d", h=heads).contiguous()
                              for t in (q, k, v))
                o3, _ = fa.attn_fwd(q3, k3, v3, scale)
                return rearrange(o3, "(b h) n d -> b n (h d)", h=heads).contiguous()

            check(torch.equal(route_3d(), o), "the packed and 3-d kernels differ")
            # in turns: packed (above), 3-d route, 3-d route, packed
            packed_ms = [row["ms"]]
            route_ms = [time_ms(route_3d), time_ms(route_3d)]
            packed_ms.append(time_ms(lambda: fa.attn_fwd_packed(q, k, v, heads, scale)))
            timed = {key: row[key] for key in TIME_KEYS}
            route_3d_ms = statistics.median(route_ms)
            row.update(route_3d_ms=route_3d_ms, ms_turns=packed_ms, route_3d_ms_turns=route_ms,
                       route_3d_device_ms=timing.device_ms(route_3d))
        print(json.dumps(row), flush=True)
        del q, k, v, o, o_ref
        torch.cuda.empty_cache()
    check(timed is not None, "the packed kernel was not timed")
    return worst, timed, route_3d_ms


def phase_fused_kernels(device) -> dict:
    """Each fused kernel against its plain version at the path's shapes,
    each limit beside a control that must fail it (`testing.*_control`:
    conv without its last 64 input channels, GroupNorm-SiLU-conv with the
    padding before the activation, GroupNorm with its last group
    unnormalised, GEGLU without the last 64 of K); at the kernel's most
    frequent shape the kernel, the plain version and the library's call
    (where one exists) timed, both by CUDA events and by device time (a row
    bound by bytes rotating over input copies for the latter), and the
    roofline bound. Also the conv core's weight repack (kernel against
    plain, bitwise) and two calls that are context, not calls that compute
    the fused function: beside the GroupNorm-SiLU-conv, F.conv2d on the
    already-activated input (the conv alone), and beside the GEGLU,
    F.linear(x, W, b) (the GEMM alone)."""
    import torch
    import torch.nn.functional as F

    from leco_tpu_torch import testing
    from leco_tpu_torch.kernels import roofline, timing
    from leco_tpu_torch.ops import conv, geglu, gn_conv
    from leco_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device)
    gen.manual_seed(2)

    def bf16(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    def fp32(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    worst = {name: 0.0 for name in FUSED}
    timed = {}
    rows = []
    extra = {}

    def held(name, shape, got, ref, control, kernel_fn, plain_fn, library_fn=None,
             rotate=None):
        """`rotate`: (input, fns_of) for a row bound by bytes, where
        fns_of(copy) gives the three calls on one copy of the input."""
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{name} non-finite at {shape}")
        err = (got.float() - ref.float()).abs().max().item()
        size = ref.float().abs().max().item()
        limit = RTOL_FUSED * size
        control_err = (control.float() - ref.float()).abs().max().item()
        check(err <= limit, f"{name} error {err} > {RTOL_FUSED} x {size} at {shape}")
        check(control_err > limit, f"the {name} limit {limit} passes its control "
                                   f"({control_err}) at {shape}")
        worst[name] = max(worst[name], err)
        row = {"kernel": name, "shape": list(shape), "max_abs_err": err, "max_abs_ref": size,
               "limit": limit, "control_err": control_err}
        if FUSED_TIMED.get(name) == tuple(shape[:len(FUSED_TIMED[name])]) and name not in timed:
            bound = roofline.kernel_bound(name, FUSED_TIMED[name])
            times = row_times((kernel_fn, plain_fn, library_fn), bound, rotate)
            if "l2_rotation_copies" in times:
                row["l2_rotation_copies"] = times.pop("l2_rotation_copies")
            timed[name] = times
            row.update(timed[name], **bound)
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    path_forward, path_dx = conv_path_shapes()
    dx_shapes = CONV_DX_SHAPES + [s for s in path_dx if s not in CONV_DX_SHAPES]
    forward_shapes = CONV_SHAPES + [s for s in path_forward if s not in CONV_SHAPES]
    for b, cin, h, w, cout in forward_shapes + dx_shapes:
        x = bf16((b, cin, h, w))
        dx = (b, cin, h, w, cout) in dx_shapes
        if dx:  # dx: the kernel on the flipped weights of a (Cin, Cout) forward conv
            wt, bias = bf16((cin, cout, 3, 3), (9 * cin) ** -0.5), None
        else:
            wt, bias = bf16((cout, cin, 3, 3), (9 * cin) ** -0.5), fp32((cout,))
        flipped = conv.flip_weight(wt) if dx else wt
        bias_bf16 = None if bias is None else bias.to(torch.bfloat16)
        packed = conv.pack_weight(wt, dx)
        torch.cuda.synchronize()
        check(torch.equal(packed, conv.pack_weight_plain(wt, dx)),
              f"the weight repack differs from its plain version at {(b, cin, h, w, cout)}")
        row = held("conv3x3", (b, cin, h, w, cout, "dx" if dx else "fwd"),
                   conv.conv3x3_gemm(x, wt, bias, flip=dx),
                   conv.conv3x3_gemm_plain(x, wt, bias, flip=dx),
                   testing.conv3x3_control(x, flipped, bias),
                   lambda: conv.conv3x3_gemm(x, wt, bias, flip=dx),
                   lambda: conv.conv3x3_gemm_plain(x, wt, bias, flip=dx),
                   lambda: F.conv2d(x, flipped, bias_bf16, padding=1))
        if "ms" in row:
            extra["repack_ms"] = {"shape": [cout, cin], **kernel_times(
                lambda: conv.pack_weight(wt), lambda: conv.pack_weight_plain(wt))}
            print(json.dumps({"repack_ms": extra["repack_ms"]}), flush=True)
    for b, cin, h, w, cout in GNCONV_SHAPES:
        x = bf16((b, cin, h, w))
        a, s = gn_conv.affine_from_gn(x, fp32((cin,), 0.1, 1.0), fp32((cin,), 0.1),
                                      fp32((b, cin)), 32, 1e-5)
        wt, bias = bf16((cout, cin, 3, 3), (9 * cin) ** -0.5), fp32((cout,))
        row = held("gnconv3x3", (b, cin, h, w, cout), gn_conv.gnconv3x3(x, a, s, wt, bias),
                   gn_conv.gnconv3x3_plain(x, a, s, wt, bias),
                   testing.gnconv3x3_control(x, a, s, wt, bias),
                   lambda: gn_conv.gnconv3x3(x, a, s, wt, bias),
                   lambda: gn_conv.gnconv3x3_plain(x, a, s, wt, bias))
        if "ms" in row:
            y, bias_bf16 = gn_conv.apply_affine_silu(x, a, s), bias.to(torch.bfloat16)
            alone = lambda: F.conv2d(y, wt, bias_bf16, padding=1)  # noqa: E731
            extra["gnconv3x3_conv_alone_ms"] = time_ms(alone)
            extra["gnconv3x3_conv_alone_device_ms"] = timing.device_ms(alone)
            print(json.dumps({key: extra[key] for key in ("gnconv3x3_conv_alone_ms",
                                                          "gnconv3x3_conv_alone_device_ms")}
                             | {"shape": [b, cin, h, w, cout]}), flush=True)
    for b, c, h, w, eps, silu in GN_SHAPES:
        x = bf16((b, c, h, w), 2.0)
        scale, bias = fp32((c,), 0.1, 1.0), fp32((c,), 0.1)
        w16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)

        def gn_fns(t, scale=scale, bias=bias, w16=w16, b16=b16, eps=eps, silu=silu):
            return (lambda: gn.group_norm_silu(t, scale, bias, 32, eps, silu),
                    lambda: gn.group_norm_silu_plain(t, scale, bias, 32, eps, silu),
                    None if silu else lambda: F.group_norm(t, 32, w16, b16, eps))

        held("group_norm", (b, c, h, w, eps, silu),
             gn.group_norm_silu(x, scale, bias, 32, eps, silu),
             gn.group_norm_silu_plain(x, scale, bias, 32, eps, silu),
             testing.group_norm_control(x, scale, bias, 32, eps, silu),
             *gn_fns(x), rotate=(x, gn_fns))
    for m, k, n, r in GEGLU_SHAPES:
        x, wt, bias = bf16((m, k)), bf16((2 * n, k), k**-0.5), fp32((2 * n,))
        xd, up = (bf16((m, r)), bf16((2 * n, r), 0.1)) if r else (None, None)
        row = held("geglu", (m, k, n, r), geglu.geglu_gemm(x, wt, bias, xd, up),
                   geglu.geglu_gemm_plain(x, wt, bias, xd, up),
                   testing.geglu_control(x, wt, bias, xd, up),
                   lambda: geglu.geglu_gemm(x, wt, bias, xd, up),
                   lambda: geglu.geglu_gemm_plain(x, wt, bias, xd, up))
        if "ms" in row:
            bias_bf16 = bias.to(torch.bfloat16)
            alone = lambda: F.linear(x, wt, bias_bf16)  # noqa: E731
            extra["geglu_gemm_alone_ms"] = time_ms(alone)
            extra["geglu_gemm_alone_device_ms"] = timing.device_ms(alone)
            print(json.dumps({key: extra[key] for key in ("geglu_gemm_alone_ms",
                                                          "geglu_gemm_alone_device_ms")}
                             | {"shape": [m, k, n, r]}), flush=True)
    torch.cuda.empty_cache()
    check(set(timed) == set(FUSED), f"timed {sorted(timed)}")
    check(set(extra) == {"repack_ms", "gnconv3x3_conv_alone_ms", "gnconv3x3_conv_alone_device_ms",
                         "geglu_gemm_alone_ms", "geglu_gemm_alone_device_ms"},
          f"extra timings {extra}")
    return {"worst_abs_err": worst, "timed_shapes": FUSED_TIMED, "timed_ms": timed,
            "rtol": RTOL_FUSED, "shapes_checked": len(rows), **extra}


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


def phase_unet_fused(bundle, device) -> dict:
    """One 512 px forward at the inner loop's batch 2 with the knobs on
    against the knobs off, with the launches of the knobs-on forward."""
    import torch

    gen = torch.Generator(device)
    gen.manual_seed(3)
    x = torch.randn((2, 4, 64, 64), generator=gen, device=device)
    ctx = torch.randn((2, 77, 768), generator=gen, device=device)
    with torch.no_grad():
        with fused_knobs(True):
            reset_launches()
            out = bundle.unet(x, 501.0, ctx).float()
            torch.cuda.synchronize()
            counts = launches()
        with fused_knobs(False):
            ref = bundle.unet(x, 501.0, ctx).float()
    err = (out - ref).abs().max().item()
    size = ref.abs().max().item()
    check(bool(torch.isfinite(out).all()), "non-finite UNet output with the knobs on")
    check(tuple(out.shape) == (2, 4, 64, 64), f"UNet output shape {tuple(out.shape)}")
    check(err <= RTOL_UNET * size, f"UNet knobs on vs off {err} > {RTOL_UNET} x {size}")
    want = {**{k: 0 for k in FLASH}, "attn_fwd": FLASH_ATTENTIONS_PER_FORWARD,
            PACKED: 0, **fused_launches("lierla", forwards=1, targets=0)}
    check(counts == want, f"per-forward launches {counts} != {want}")
    return {"max_abs_err": err, "max_abs_ref": size, "launches_per_forward": counts}


def phase_profile(bundle, device, timesteps_to: int = 10) -> dict:
    """One train step (t_to inner forwards + the 3B references + the
    differentiated target) under torch.profiler, read by
    `scripts/profile_step.analyze`: the device's busy and idle share, the
    kernels that take its time, the time by category and by UNet
    component. Then the same step with the kernels and with plain
    attention, in turns (flash, plain, plain, flash); then with the knobs
    on, profiled the same way, against the knobs off in turns."""
    import torch

    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.scripts import profile_step
    from leco_tpu_torch.train import trainer
    from leco_tpu_torch.train.optim import get_optimizer

    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": 512})
    pack = trainer.build_pack(trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0])
    opt = get_optimizer("adamw", list(bundle.lora_params.values()), 1e-4)
    step_fn = trainer.make_train_step(bundle, opt, 50)
    gen = torch.Generator(device)
    gen.manual_seed(0)

    def step():
        step_fn(pack, 1.0, 1.0, timesteps_to, height=512, width=512, generator=gen)

    def run():
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def profiled() -> dict:
        result = profile_step.profile_steps(step, bundle.unet, device, steps=1)
        result["top_kernels"] = result["top_kernels"][:15]
        components = result["by_component_ms_share"]
        unet_share = sum(share for name, (_, share) in components.items()
                         if name != profile_step.OUTSIDE)
        check(result["component_scopes"] > 0 and unet_share > 0.5,
              f"the UNet components hold {unet_share} of the busy time "
              f"({result['component_scopes']} scopes on the device timeline)")
        return result

    def share(result: dict, prefixes: tuple) -> float:
        return sum(s for name, (_, s) in result["by_category_ms_share"].items()
                   if name.startswith(prefixes))

    bundle.unet.set_attention_backend("xla")
    run()  # warm-up of the plain route: cuDNN/cuBLAS pick algorithms
    bundle.unet.set_attention_backend("flash")
    off = profiled()
    walls = {"flash": [], "plain": []}
    for backend in ("flash", "plain", "plain", "flash"):
        bundle.unet.set_attention_backend("flash" if backend == "flash" else "xla")
        walls[backend].append(run())
    bundle.unet.set_attention_backend("flash")

    # the same step with the fused configuration's knobs on
    with fused_knobs(True):
        on = profiled()
    knob_walls = {"on": [], "off": []}
    for side in ("off", "on", "on", "off"):
        with fused_knobs(side == "on"):
            knob_walls[side].append(run())
    return {
        "timesteps_to": timesteps_to,
        **off,
        "flash_kernels_share_of_busy": share(off, ("kernel 1", "kernel 2", "kernel 3")),
        "flash_fwd_share_of_busy": share(off, ("kernel 1",)),
        "step_s_flash_vs_plain_attention": walls,
        "knobs_on": {**on, "fused_kernels_share_of_busy": share(on, ("kernel 5", "kernel 7",
                                                                     "kernel 8"))},
        "step_s_knobs_on_vs_off": knob_walls,
    }


# phase bench: the port's measurement entry points, in process. bench.main
# knobs off and on (the knobs-on run with LECO_FLASH_PACKED=1 too: kernels
# 4-8); bench_full cut to BENCH_FULL_ITERATIONS; profile_unet at
# PROFILE_UNET_ITERS calls a timing
BENCH_FULL_ITERATIONS = 20
PROFILE_UNET_ITERS = 2


def entry_point(main_fn, argv: list) -> tuple[dict, dict]:
    """Run an entry point's `main(argv)` with its standard output captured
    and echoed -> (its record, the one JSON line it printed, parsed)."""
    with echoed_stdout() as out:
        record = main_fn(argv)
    text = out.getvalue()
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"{len(lines)} JSON lines printed")
    return record, lines[0]


def finite_positive(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def bench_run(knobs_on: bool) -> dict:
    """`leco_tpu_torch.bench.main` on the card, its launches of kernels 1-8
    held to what the warm-up and the t_to sample imply: t + 2 UNet forwards
    and one target backward an iteration."""
    import torch

    from leco_tpu_torch import bench

    with environ({k: v if knobs_on else None for k, v in PARALLEL_KNOBS.items()}):
        reset_launches()
        record, line = entry_point(bench.main, ["--device", "cuda"])
        torch.cuda.synchronize()
        counts = launches()
    check(line == record, "the printed line is not the returned record")
    check(record["metric"] == "LoRA train iters/sec/chip, SD1.5 512px bf16 rank4 ddim",
          f"metric {record['metric']!r}")
    t_tos = record["timesteps_to"]
    check(t_tos == [42, 32, 26, 14, 16, 3, 4, 1, 9, 40, 32, 45], f"t_to sample {t_tos}")
    forwards = bench.WARM_UP_TIMESTEPS_TO + 2 + 2 * sum(t + 2 for t in t_tos)
    iterations = 1 + 2 * len(t_tos)
    if knobs_on:
        want = {**{name: 0 for name in KERNELS},
                PACKED: FLASH_ATTENTIONS_PER_FORWARD * forwards,
                **fused_launches("lierla", forwards, iterations)}
    else:
        want = flash_launches(forwards, iterations)
    check(counts == want, f"bench launches {counts} != {want}")
    losses = [record["losses"]["warm_up"], *record["losses"]["per_iter"],
              *record["losses"]["deferred"]]
    check(all(math.isfinite(v) for v in losses), f"bench losses {losses}")
    check(finite_positive(record["value"]) and finite_positive(record["per_iter_its_per_sec"]),
          f"it/s {record['value']}, per_iter {record['per_iter_its_per_sec']}")
    check(finite_positive(record["mfu"]) and record["mfu"] <= 1, f"mfu {record['mfu']}")
    check(record["kernels_built_now"] is False, "the bench built the kernels again")
    check(record["device"].get("nvidia_smi") is not None, f"device {record['device']}")
    return {"record": record, "launches": counts}


def phase_bench(out_dir: Path) -> dict:
    """The measurement entry points on the card: the bench knobs off, then
    on; bench_full cut to BENCH_FULL_ITERATIONS iterations (its record, the
    metrics.jsonl lines, exact launches, the final save read back);
    profile_unet at PROFILE_UNET_ITERS calls a timing."""
    import torch

    from leco_tpu_torch.lora import read_safetensors
    from leco_tpu_torch.scripts import bench_full, profile_unet

    seconds = {}
    t0 = time.perf_counter()
    off = bench_run(knobs_on=False)
    seconds["bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on = bench_run(knobs_on=True)
    seconds["bench_knobs_on"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    full_dir = out_dir / "bench_full"
    with environ({"LECO_FULL_ITERS": str(BENCH_FULL_ITERATIONS), "LECO_FULL_OUT": str(full_dir)}):
        reset_launches()
        full, line = entry_point(bench_full.main, ["--device", "cuda"])
        torch.cuda.synchronize()
        counts = launches()
    seconds["bench_full"] = time.perf_counter() - t0
    check(line == full, "bench_full: the printed line is not the returned record")
    check(full["n_losses"] == BENCH_FULL_ITERATIONS and full["losses_finite"],
          f"bench_full losses: {full['n_losses']}, finite {full['losses_finite']}")
    check(full["metrics_jsonl_lines"] == BENCH_FULL_ITERATIONS,
          f"bench_full metrics.jsonl lines {full['metrics_jsonl_lines']}")
    check(full["saves_written"] == ["van_gogh_last.safetensors"],
          f"bench_full saves {full['saves_written']}")
    check(finite_positive(full["steady_state_its_per_sec"])
          and full["memory_stats"]["max_memory_allocated"] > 0
          and full["kernels_built_now"] is False, f"bench_full record {full}")
    records = [json.loads(ln) for ln in (full_dir / "metrics.jsonl").read_text().splitlines()]
    forwards = sum(r["timesteps_to"] + 2 for r in records)
    want = flash_launches(forwards, BENCH_FULL_ITERATIONS)
    check(counts == want, f"bench_full launches {counts} != {want}")
    state, _ = read_safetensors(full_dir / "van_gogh_last.safetensors")
    check(len(state) > 0 and all(bool(torch.isfinite(v.float()).all()) for v in state.values()),
          "bench_full's final save")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    unet, line = entry_point(profile_unet.main, ["--iters", str(PROFILE_UNET_ITERS)])
    seconds["profile_unet"] = time.perf_counter() - t0
    check(line == unet, "profile_unet: the printed line is not the returned record")
    for key, row in unet["results"].items():
        check(all(finite_positive(row[k]) for k in ("fwd_ms", "fwd_bwd_ms"))
              and all(0 < row[k] <= 1 for k in ("mfu_fwd", "mfu_fwd_bwd")),
              f"profile_unet {key}: {row}")
    torch.cuda.empty_cache()
    return {"knobs_off": off, "knobs_on": on, "bench_full": full,
            "bench_full_launches": counts, "profile_unet": unet, "seconds": seconds}


# phase scripts: the last measurement entry points, in process. profile_fwd
# on the bare forward (4 runs); the conv microbenchmarks at SCRIPTS_ITERS
# chained calls a pass (their default is 64)
SCRIPTS_ITERS = 16


def profile_fwd_run(argv: list, knobs: dict, per_forward: dict) -> dict:
    """`scripts/profile_fwd.main(argv)` with `knobs` set, its launches held
    to `per_forward` (kernel -> launches a forward) times the calls it made."""
    import torch

    from leco_tpu_torch.scripts import profile_fwd, profile_step

    with environ(knobs):
        reset_launches()
        record, line = entry_point(profile_fwd.main, argv)
        torch.cuda.synchronize()
        counts = launches()
    what = f"profile_fwd {' '.join(argv)} {knobs}"
    check(line == record, f"{what}: the printed line is not the returned record")
    check(record["first_output_finite"], f"{what}: the first output is not finite")
    want = {name: per_forward.get(name, 0) * record["calls"] for name in KERNELS}
    check(counts == want, f"{what}: launches {counts} != {want}")
    check(finite_positive(record["device_busy_s"]) and finite_positive(record["wall_ms_per_call"]),
          f"{what}: busy {record['device_busy_s']}, wall {record['wall_ms_per_call']}")
    unet_share = sum(share for name, (_, share) in record["by_component_ms_share"].items()
                     if name != profile_step.OUTSIDE)
    check(unet_share > 0.5, f"{what}: the UNet components hold {unet_share} of the busy time")
    torch.cuda.empty_cache()
    keep = ("model", "res", "batch", "attn", "calls", "wall_ms_per_call", "device_busy_s",
            "device_idle_share", "kernel_launches", "component_scopes", "by_category_ms_share",
            "by_component_ms_share", "knobs", "backend_flags")
    return {**{k: record[k] for k in keep}, "top_kernels": record["top_kernels"][:15],
            "launches": counts, "unet_share_of_busy": unet_share}


def conv_times_ok(timed: dict, what: str, mfu_keys=("mfu", "device_mfu")) -> None:
    """Every time finite and positive, every MFU in (0, 1]."""
    check(finite_positive(timed["ms"]) and finite_positive(timed["device_ms"]),
          f"{what}: ms {timed['ms']}, device_ms {timed['device_ms']}")
    for key in mfu_keys:
        check(finite_positive(timed[key]) and timed[key] <= 1, f"{what}: {key} {timed[key]}")


def phase_scripts() -> dict:
    """profile_fwd four times (SD1.5 knobs off, knobs on with the packed
    route, SDXL at 1024 px, SD1.5 with plain attention), then bench_convs
    (the three layouts, then --matmul), bench_pallas_conv (its output check
    at every shape) and ab_convfold (SD and --xl) in process, each printed
    line the returned record."""
    import torch

    from leco_tpu_torch.scripts import ab_convfold, bench_convs, bench_pallas_conv

    seconds, out = {}, {}
    flash = {"attn_fwd": FLASH_ATTENTIONS_PER_FORWARD}
    knobs_on = {PACKED: FLASH_ATTENTIONS_PER_FORWARD,
                **fused_launches("lierla", forwards=1, targets=0)}
    for label, argv, knobs, per_forward in (
            ("profile_fwd", [], {}, flash),
            ("profile_fwd_knobs_on", [], PARALLEL_KNOBS, knobs_on),
            ("profile_fwd_sdxl", ["--model", "sdxl", "--res", str(XL_RESOLUTION)], {},
             {"attn_fwd": XL_FLASH_PER_FORWARD}),
            ("profile_fwd_plain_attention", ["--attn", "xla"], {}, {})):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as logdir:
            out[label] = profile_fwd_run(argv + ["--logdir", logdir], knobs, per_forward)
        seconds[label] = time.perf_counter() - t0

    iters = ["--iters", str(SCRIPTS_ITERS)]
    t0 = time.perf_counter()
    convs, line = entry_point(bench_convs.main, iters)
    check(line == convs, "bench_convs: the printed line is not the returned record")
    for row in convs["rows"]:
        for key in (*bench_convs.LAYOUTS, "im2col"):
            if row[key] is not None:
                conv_times_ok(row[key], f"bench_convs {row['case']} {key}")
    gemms, line = entry_point(bench_convs.main, iters + ["--matmul"])
    check(line == gemms, "bench_convs --matmul: the printed line is not the returned record")
    for row in gemms["rows"]:
        conv_times_ok(row["gemm"], f"bench_convs --matmul {row['case']}")
    out["bench_convs"], out["bench_convs_matmul"] = convs, gemms
    seconds["bench_convs"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_launches()
    kernel, line = entry_point(bench_pallas_conv.main, iters)
    torch.cuda.synchronize()
    counts = launches()
    check(line == kernel, "bench_pallas_conv: the printed line is not the returned record")
    want = {name: 0 for name in KERNELS}
    want["conv3x3"] = kernel["kernel_calls"]
    check(kernel["kernel_calls"] > 0 and counts == want,
          f"bench_pallas_conv launches {counts} != {want}")
    for row in kernel["rows"]:
        for impl in ("xla", "kernel"):
            what = f"bench_pallas_conv {row['case']} {impl}"
            conv_times_ok(row[impl], what)
            check(finite_positive(row[impl]["mfu_adjusted"]),
                  f"{what}: mfu_adjusted {row[impl]['mfu_adjusted']}")
        check(finite_positive(row["repack_device_ms"]),
              f"bench_pallas_conv {row['case']}: repack {row['repack_device_ms']}")
        held = row["check"]
        check(kernel["rtol"] == RTOL_FUSED
              and held["max_abs_err"] <= held["limit"] < held["control_max_abs_err"],
              f"bench_pallas_conv {row['case']}: the output check {held} at rtol "
              f"{kernel['rtol']}")
    out["bench_pallas_conv"] = {**kernel, "launches": counts}
    seconds["bench_pallas_conv"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    for label, argv in (("ab_convfold", iters), ("ab_convfold_xl", iters + ["--xl"])):
        t0 = time.perf_counter()
        fold, line = entry_point(ab_convfold.main, argv)
        check(line == fold, f"{label}: the printed line is not the returned record")
        pin = fold["pin"]
        check(pin["max_abs_diff"] <= pin["limit"] < pin["control_max_abs_diff"],
              f"{label}: the fold pin {pin}")
        for row in fold["rows"]:
            for side in ("plain", "folded"):
                conv_times_ok(row[side], f"{label} {row['case']} {side}", mfu_keys=())
        out[label] = fold
        seconds[label] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return {**out, "seconds": seconds}


def phase_train(bundle, out_dir: Path, fused: bool = False) -> dict:
    """3 iterations of train(): the default path, or with `fused` the
    fused configuration's knobs on, on the bundle's LoRA network (lierla or
    c3lier). Every kernel's launches are checked."""
    import torch

    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.lora import count_lora_modules, read_safetensors
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train.trainer import train
    from leco_tpu_torch.utils.debug import check_frozen_params, check_trainable_params

    iterations = 3
    # per_steps 1: with 3 iterations, a save every 2 steps would fall on the
    # last iteration, which the loop leaves to the final save
    config = RootConfig.from_dict({
        "prompts_file": "(in-code)",
        "pretrained_model": {"name_or_path": "(random sd15 bundle)"},
        "network": {"type": bundle.spec.network_type, "rank": 4, "alpha": 1.0,
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

    encode_fn = bundle.encode_fn  # train() frees it, as the reference does
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fused_knobs(fused):
        reset_launches()
        t0 = time.perf_counter()
        try:
            result = train(config, prompts, bundle,
                           on_step=lambda i, loss: stamps.append(time.perf_counter()))
        finally:
            bundle.encode_fn = encode_fn
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches()

    losses = result["losses"]
    check(len(losses) == iterations, f"{len(losses)} losses")
    check(all(torch.isfinite(torch.tensor(losses)).tolist()), f"losses {losses}")
    records = [json.loads(ln) for ln in (out_dir / "metrics.jsonl").read_text().splitlines()]
    check(len(records) == iterations, f"metrics.jsonl has {len(records)} lines")
    tsto = [r["timesteps_to"] for r in records]
    forwards = sum(t + 2 for t in tsto)
    want = {
        "attn_fwd": FLASH_ATTENTIONS_PER_FORWARD * forwards,
        "attn_bwd_dq": FLASH_ATTENTIONS_PER_FORWARD * iterations,
        "attn_bwd_dkv": FLASH_ATTENTIONS_PER_FORWARD * iterations,
        PACKED: 0,
        **{name: 0 for name in FUSED},
    }
    if fused:
        want.update(fused_launches(bundle.spec.network_type, forwards, iterations))
    check(counts == want, f"launches {counts} != {want}")

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
    print(f"train seconds per iteration{' (knobs on)' if fused else ''}"
          f" ({bundle.spec.network_type}): "
          f"{json.dumps(per_iter)} (timesteps_to {tsto})", flush=True)
    return {"losses": losses, "timesteps_to": tsto, "launches": counts,
            "seconds": seconds, "seconds_per_iteration": per_iter,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "lora_layers": n_layers, "lora_tensors_changed": changed}


# phase jax_knobs: the JAX trainer's last runtime knobs on the SD1.5 bundle.
# The fold A/B runs the step's inner denoise at this t_to; its LoRA gets
# seeded nonzero up weights of this std (at zero the fold and the literal
# branch agree trivially), which must move the denoise so far that the
# LoRA-off control misses the RTOL_UNET limit by FOLD_CONTROL_FACTOR or
# more; the two routes are timed in the turns of FOLD_TURNS ("on": the
# literal branch)
KNOBS_TIMESTEPS_TO = 10
FOLD_LORA_UP_STD = 1.0
FOLD_CONTROL_FACTOR = 3.0
FOLD_TURNS = ("fold", "on", "on", "fold") * 2
GNCONV_TIMED_CALLS = 3


def seed_lora_up(bundle, std: float, seed: int = 0) -> None:
    """Every `lora_up` of the bundle's LoRA drawn from N(0, std²), seeded."""
    import torch

    gen = torch.Generator(bundle.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(bundle.lora_params.items()):
            if name.endswith("lora_up"):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=p.dtype) * std)


def fold_ab(bundle, device) -> dict:
    """The inner loop's LoRA fold against the literal LoRA branch (the JAX
    trainer's LECO_FOLD_INNER=0; the port always folds). The train step's
    inner denoise (KNOBS_TIMESTEPS_TO DDIM steps of 50, guidance 3, one
    prompt's CFG batch of 2) from the same latents under `folded_lora` and
    under `lora_mode(unet, "on")`, the LoRA's up weights seeded nonzero:
    the literal denoise within RTOL_UNET x max|the fold's|, the same
    denoise with the LoRA off (the control) at least FOLD_CONTROL_FACTOR
    times that limit away, the flash launches of t_to forwards in each.
    Then the two routes in the turns of FOLD_TURNS: the whole denoise by
    CUDA events (the host's time counts); after those turns, in the same
    turns, the device busy time of one denoise step inside the route and,
    in each fold turn, of the fold itself (`kernels/timing.profiled`; a
    session of the whole denoise's launches would take the profiler
    seconds to read) -> each route's samples and median."""
    import functools

    import torch

    from leco_tpu_torch.kernels import timing
    from leco_tpu_torch.lora import folded_lora, lora_mode
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train import diffusion as diff
    from leco_tpu_torch.train import trainer

    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": SD15_RESOLUTION})
    pack = trainer.build_pack(trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0])
    original = {k: v.detach().clone() for k, v in bundle.lora_params.items()}
    seed_lora_up(bundle, FOLD_LORA_UP_STD)
    state_n = bundle.scheduler.set_timesteps(50)
    gen = torch.Generator(device)
    gen.manual_seed(0)
    latents = diff.get_initial_latents(gen, state_n, 1, SD15_RESOLUTION, SD15_RESOLUTION,
                                       device)

    def denoise(mode: str, steps: int = KNOBS_TIMESTEPS_TO):
        route = folded_lora(bundle.unet) if mode == "fold" else lora_mode(bundle.unet, mode)
        with torch.no_grad(), route:
            return diff.diffusion(bundle.unet, state_n, latents, pack["inner_embeds"], steps,
                                  guidance_scale=3.0)

    out, counts = {}, {}
    for mode in ("fold", "on", "off"):
        reset_launches()
        out[mode] = denoise(mode).float()
        torch.cuda.synchronize()
        counts[mode] = launches()
    ref = out["fold"]
    size = ref.abs().max().item()
    limit = RTOL_UNET * size
    err = (out["on"] - ref).abs().max().item()
    control_err = (out["off"] - ref).abs().max().item()
    check(bool(torch.isfinite(ref).all() and torch.isfinite(out["on"]).all()),
          "non-finite inner denoise")
    check(err <= limit, f"the literal LoRA branch's denoise {err} > {RTOL_UNET} x {size}")
    check(control_err >= FOLD_CONTROL_FACTOR * limit,
          f"the LoRA-off control {control_err} misses the fold limit {limit} by less than "
          f"{FOLD_CONTROL_FACTOR}x")
    want = flash_launches(KNOBS_TIMESTEPS_TO, 0)
    for mode, got in counts.items():
        check(got == want, f"{mode} denoise: launches {got} != {want}")

    def busy_ms(fn) -> float:
        return timing.per_call_ms(timing.profiled(fn, device)[1], 1)

    def fold_and_drop():
        with folded_lora(bundle.unet):
            pass

    wall = {mode: [] for mode in FOLD_TURNS}
    step_busy = {mode: [] for mode in FOLD_TURNS}
    fold_busy = []
    for mode in FOLD_TURNS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        denoise(mode)
        end.record()
        end.synchronize()
        wall[mode].append(start.elapsed_time(end))
    for mode in FOLD_TURNS:
        route = folded_lora(bundle.unet) if mode == "fold" else lora_mode(bundle.unet, mode)
        with torch.no_grad(), route:
            step_busy[mode].append(busy_ms(functools.partial(
                diff.diffusion, bundle.unet, state_n, latents, pack["inner_embeds"], 1,
                guidance_scale=3.0)))
        if mode == "fold":
            with torch.no_grad():
                fold_busy.append(busy_ms(fold_and_drop))
    with torch.no_grad():
        for k, p in bundle.lora_params.items():
            p.copy_(original[k])
    result = {"timesteps_to": KNOBS_TIMESTEPS_TO, "lora_up_std": FOLD_LORA_UP_STD,
              "denoised_err": err, "denoised_limit": limit, "denoised_control": control_err,
              "max_abs_ref": size, "launches": counts["fold"], "turns": list(FOLD_TURNS),
              "denoise_ms": wall, "step_busy_ms": step_busy, "fold_busy_ms": fold_busy,
              "denoise_ms_median": {m: statistics.median(t) for m, t in wall.items()},
              "step_busy_ms_median": {m: statistics.median(t) for m, t in step_busy.items()},
              "fold_busy_ms_median": statistics.median(fold_busy)}
    print(f"jax_knobs fold A/B (t_to {KNOBS_TIMESTEPS_TO}): denoised error {err} (limit "
          f"{limit}, LoRA-off control {control_err}); turns {list(FOLD_TURNS)}: denoise ms "
          f"{json.dumps(wall)}; device busy ms of a denoise step {json.dumps(step_busy)}, "
          f"of the fold {json.dumps(fold_busy)}", flush=True)
    return result


def gnconv_ab(bundle, device) -> dict:
    """One 512 px forward at batch 2 with the fused knobs on and
    LECO_GNCONV_KERNEL=0: every resnet conv refused by the gnconv gate
    (gnconv3x3 launched 0 times, the GroupNorm kernel and conv3x3 in its
    place), the output bitwise the same forward's with LECO_RESNET_FUSED
    unset; the knobs-on forward's device time with and without the
    variable (one profiled session of GNCONV_TIMED_CALLS forwards each)."""
    import torch

    from leco_tpu_torch.kernels import timing

    gen = torch.Generator(device)
    gen.manual_seed(3)
    side = SD15_RESOLUTION // 8
    x = torch.randn((2, 4, side, side), generator=gen, device=device)
    ctx = torch.randn((2, 77, bundle.unet.cfg.cross_attention_dim), generator=gen,
                      device=device)

    def forward():
        return bundle.unet(x, 501.0, ctx)

    def forward_ms() -> float:
        _, events = timing.profiled(forward, device, calls=GNCONV_TIMED_CALLS, alike=True)
        return timing.per_call_ms(events, GNCONV_TIMED_CALLS)

    with torch.no_grad(), fused_knobs(True):
        with environ({"LECO_GNCONV_KERNEL": "0"}):
            refused = refused_convs("sd15", SD15_RESOLUTION)
            reset_launches()
            out = forward().float()
            torch.cuda.synchronize()
            counts = launches()
            refused_ms = forward_ms()
        with environ({"LECO_RESNET_FUSED": None}):
            ref = forward().float()
        forward()  # the gnconv route's first call outside the session
        fused_ms = forward_ms()
    convs = unet_convs("sd15", SD15_RESOLUTION)
    check(len(refused) == len(convs), f"LECO_GNCONV_KERNEL=0 refuses {len(refused)} of "
                                      f"{len(convs)} resnet convs")
    check(bool(torch.isfinite(out).all()), "non-finite UNet output under LECO_GNCONV_KERNEL=0")
    check(torch.equal(out, ref), "LECO_GNCONV_KERNEL=0 is not bitwise the unfused resnet: "
                                 f"{(out - ref).abs().max().item()}")
    want = {**{k: 0 for k in FLASH}, "attn_fwd": FLASH_ATTENTIONS_PER_FORWARD, PACKED: 0,
            **fused_launches("lierla", 1, 0,
                             convs=(0, len(refused), sum(c[4] for c in refused)))}
    check(counts == want, f"LECO_GNCONV_KERNEL=0 launches {counts} != {want}")
    print(f"jax_knobs gnconv A/B: knobs-on forward device ms {fused_ms} (gnconv3x3 on), "
          f"{refused_ms} (LECO_GNCONV_KERNEL=0)", flush=True)
    return {"launches": counts, "forward_device_ms": {"gnconv3x3": fused_ms,
                                                      "gnconv_kernel_0": refused_ms}}


def phase_jax_knobs(bundle, device) -> dict:
    """The fold against the literal LoRA branch and LECO_GNCONV_KERNEL=0 on
    the SD1.5 bundle (LECO_TRAIN_STAGES=1 rides on phase cli's default
    run)."""
    return {"fold": fold_ab(bundle, device), "gnconv": gnconv_ab(bundle, device)}


TRAIN_STAGE = re.compile(r"^\[train \+ *(\d+\.\d)s\] (.*)$")
TRAIN_STAGES = 8


def train_stages(text: str) -> list:
    """The LECO_TRAIN_STAGES=1 lines of a run's output -> [[seconds,
    message]]: eight, the five setup stages then the loop's three, their
    times never decreasing."""
    stages = [[float(m.group(1)), m.group(2)] for m in map(TRAIN_STAGE.match, text.splitlines())
              if m]
    check(len(stages) == TRAIN_STAGES, f"{len(stages)} train stages printed")
    check([msg.split(":")[0] for _, msg in stages] == ["setup"] * 5 + ["loop"] * 3,
          f"train stages out of order: {stages}")
    times = [t for t, _ in stages]
    check(times == sorted(times), f"train stage times decrease: {times}")
    return stages


@contextlib.contextmanager
def echoed_stdout():
    """Standard output captured inside the block (the StringIO yielded) and
    written out after it, also when the block raises."""
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            yield out
    finally:
        sys.stdout.write(out.getvalue())
        sys.stdout.flush()


def write_config(config: dict, path: Path) -> None:
    """A two-level config dict as block YAML (scalars as JSON, which the
    YAML subset reads as double-quoted strings, numbers, bools, null)."""
    lines = []
    for key, value in config.items():
        if isinstance(value, dict):
            lines.append(f"{key}:")
            lines += [f"  {k}: {json.dumps(v)}" for k, v in value.items()]
        else:
            lines.append(f"{key}: {json.dumps(value)}")
    path.write_text("\n".join(lines) + "\n")


def safetensors_shapes(path: Path) -> dict[str, tuple]:
    """{name: shape} from a .safetensors header, without reading the data."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return {k: tuple(v["shape"]) for k, v in header.items()}


def phase_cli(device, out_dir: Path) -> dict:
    """The default recipe (examples/config.yaml: SD2.1, v-prediction, DDIM,
    bf16, rank-4 lierla; examples/prompts.yaml: van gogh, 512 px, batch 2)
    through the CLI's `main()` on a random full-width SD2.1 single file,
    once on the 3-d flash kernels and once with LECO_FLASH_PACKED=1."""
    import torch

    from leco_tpu_torch import testing
    from leco_tpu_torch.lora import count_lora_modules, read_safetensors
    from leco_tpu_torch.utils import yaml_subset

    t0 = time.perf_counter()
    ckpt = testing.write_single_file_checkpoint(
        out_dir / SD21_CHECKPOINT, seed=0, dtype=torch.float16, device=device)
    write_seconds = time.perf_counter() - t0
    shapes = safetensors_shapes(ckpt)
    unet_keys = {k: s for k, s in shapes.items() if k.startswith("model.diffusion_model.")}
    fixture = {}
    for line in (REPO / "tests" / "fixtures" / "ldm_unet_keys_sd21.txt").read_text().splitlines():
        key, shape = line.split()
        fixture[key] = tuple(int(x) for x in shape.split(","))
    check(unet_keys == fixture, "the written UNet's LDM keys and shapes are not SD2.1's: "
          f"{sorted(set(unet_keys) ^ set(fixture))[:5]}")
    check(sum(k.startswith("cond_stage_model.model.transformer.resblocks.")
              and k.endswith(".ln_1.weight") for k in shapes) == 24, "OpenCLIP resblocks")
    print(f"checkpoint: {ckpt.stat().st_size / 2**30:.2f} GiB, {len(shapes)} tensors, "
          f"written in {write_seconds:.1f} s", flush=True)

    config = yaml_subset.load(REPO / "examples" / "config.yaml")
    config["prompts_file"] = str(REPO / "examples" / "prompts.yaml")
    config["pretrained_model"]["name_or_path"] = str(ckpt)
    config["train"]["iterations"] = 3
    config["save"]["per_steps"] = 1
    iterations = 3
    runs = {}
    for packed in (False, True):
        name = "packed" if packed else "default"
        save_dir = out_dir / name
        config["save"]["path"] = str(save_dir)
        # the default run prints train()'s setup stages (LECO_TRAIN_STAGES=1)
        with environ({"LECO_FLASH_PACKED": "1" if packed else None,
                      "LECO_TRAIN_STAGES": None if packed else "1"}), echoed_stdout() as out:
            run = run_cli(config, out_dir / f"config_{name}.yaml")
        result, counts = run["result"], run["launches"]

        losses = result["losses"]
        check(len(losses) == iterations, f"{name}: {len(losses)} losses")
        check(all(torch.isfinite(torch.tensor(losses)).tolist()), f"{name}: losses {losses}")
        records = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
        check(len(records) == iterations, f"{name}: metrics.jsonl has {len(records)} lines")
        tsto = [r["timesteps_to"] for r in records]
        check(all(r["resolution"] == [512, 512] for r in records), f"{name}: resolution")
        forwards = sum(t + 2 for t in tsto)
        want = {name_: 0 for name_ in launches()}
        if packed:
            want[PACKED] = FLASH_ATTENTIONS_PER_FORWARD * forwards
        else:
            want.update({"attn_fwd": FLASH_ATTENTIONS_PER_FORWARD * forwards,
                         "attn_bwd_dq": FLASH_ATTENTIONS_PER_FORWARD * iterations,
                         "attn_bwd_dkv": FLASH_ATTENTIONS_PER_FORWARD * iterations})
        check(counts == want, f"{name}: launches {counts} != {want}")

        last = save_dir / "van_gogh_last.safetensors"
        periodic = save_dir / "van_gogh_1steps.safetensors"
        check(last.exists() and periodic.exists(), f"{name}: saves missing")
        state, metadata = read_safetensors(last)
        read_safetensors(periodic)
        n_layers = count_lora_modules(result["lora"])
        check(len(state) == 3 * n_layers, f"{name}: {len(state)} tensors, {n_layers} layers")
        for k, v in result["lora"].items():
            layer, part = k.rsplit(".", 1)
            key = "lora_unet_" + layer.replace(".", "_") + f".{part}.weight"
            check(torch.equal(state[key], v.to(torch.bfloat16)), f"{name}: saved {key} differs")
        check('"v_pred": true' in metadata["config"], f"{name}: metadata")

        per_iter = iteration_seconds(run)
        print(f"cli {name}: seconds per iteration {json.dumps(per_iter)} "
              f"(timesteps_to {tsto}), peak {run['peak_mem_gb']:.2f} GiB", flush=True)
        runs[name] = {
            "losses": losses, "timesteps_to": tsto, "launches": counts,
            "seconds": run["seconds"], "load_seconds": run["load_end"][0] - run["t0"],
            "seconds_per_iteration": per_iter, "peak_mem_gb": run["peak_mem_gb"],
            "lora_layers": n_layers,
        }
        if not packed:
            stages = train_stages(out.getvalue())
            print(f"cli {name}: train stages (s since train() began) {json.dumps(stages)}",
                  flush=True)
            runs[name]["train_stages"] = stages
        else:
            check(not any(map(TRAIN_STAGE.match, out.getvalue().splitlines())),
                  f"{name}: train stages printed with LECO_TRAIN_STAGES unset")
        del run, result, state
    # same weights, seed and schedule: the first loss (forwards only, before
    # any update) on the packed kernel is the 3-d kernels' up to the order of
    # cuBLAS sums elsewhere in the UNet
    a, b = runs["default"]["losses"][0], runs["packed"]["losses"][0]
    check(runs["default"]["timesteps_to"] == runs["packed"]["timesteps_to"], "schedules differ")
    check(abs(a - b) <= 2e-2 * abs(a), f"first loss {a} (3-d) vs {b} (packed)")
    return {"checkpoint_gib": ckpt.stat().st_size / 2**30, "write_seconds": write_seconds,
            **runs}


def lora_grads(bundle) -> dict:
    return {k: p.grad.detach().float().clone() for k, p in bundle.lora_params.items()}


def grads_gate(got: dict, ref: dict, control: dict, rtol: float, what: str) -> dict:
    """Hold LoRA grads to rtol x max|ref| over the whole tree, and check that
    this limit fails `control` (the grads of the same step on other
    latents) -> the error, the limit, the control's error, bitwise equal."""
    import torch

    size = max(v.abs().max().item() for v in ref.values())
    err = max((got[k] - v).abs().max().item() for k, v in ref.items())
    control_err = max((control[k] - v).abs().max().item() for k, v in ref.items())
    limit = rtol * size
    check(err <= limit, f"{what}: LoRA grads differ by {err} > {rtol} x {size}")
    check(control_err > limit, f"{what}: the limit {limit} passes the control ({control_err})")
    return {"grad_err": err, "grad_limit": limit, "grad_control": control_err,
            "bitwise": all(torch.equal(got[k], v) for k, v in ref.items())}


def unreal_config(ckpt: Path, save_dir: Path) -> dict:
    """examples/unreal_config.yaml as it is, but for the checkpoint, the
    iterations, the save path and cadence, save_state, ema_decay and a seed
    (the recipe sets none, and an unseeded run draws its own schedule, so
    no other run could replay it)."""
    from leco_tpu_torch.utils import yaml_subset

    config = yaml_subset.load(REPO / "examples" / "unreal_config.yaml")
    config["prompts_file"] = str(REPO / "examples" / "unreal_prompts.yaml")
    config["pretrained_model"]["name_or_path"] = str(ckpt)
    config["train"].update(iterations=UNREAL_ITERATIONS, save_state=True,
                           ema_decay=UNREAL_EMA_DECAY, seed=0)
    config["save"].update(path=str(save_dir), per_steps=UNREAL_PER_STEPS)
    return config


def run_cli(config: dict, config_path: Path, on_step=None, cli: str = "train_lora") -> dict:
    """`main()` of the port's CLI `leco_tpu_torch.<cli>` (`train_lora`,
    `train_lora_xl` or `train_ti`) on `config` with every launch count at 0
    before it -> {"result", "launches", "seconds", "stamps", "load_end",
    "peak_mem_gb"}. `wandb` is made unimportable: `use_wandb: true` then
    takes the JAX trainer's "not installed" path and nothing reaches a
    network."""
    import importlib

    import torch

    from leco_tpu_torch.models import loader
    from leco_tpu_torch.train_lora import parse_args

    cli_main = importlib.import_module(f"leco_tpu_torch.{cli}").main
    load_name = "load_models_xl" if cli == "train_lora_xl" else "load_models"
    write_config(config, config_path)
    stamps, load_end = [], []
    real_load = getattr(loader, load_name)

    def timed_load(*args, **kwargs):
        models = real_load(*args, **kwargs)
        torch.cuda.synchronize()
        load_end.append(time.perf_counter())
        return models

    def hook(i, loss):
        stamps.append(time.perf_counter())
        if on_step is not None:
            on_step(i, loss)

    saved_wandb = sys.modules.get("wandb", "absent")
    sys.modules["wandb"] = None
    setattr(loader, load_name, timed_load)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = {"result": None}
    try:
        out["result"] = cli_main(parse_args(["--config_file", str(config_path)]), on_step=hook)
    finally:
        setattr(loader, load_name, real_load)
        if saved_wandb == "absent":
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
        torch.cuda.synchronize()
        out.update(launches=launches(), seconds=time.perf_counter() - t0, stamps=stamps,
                   load_end=load_end, t0=t0,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def iteration_seconds(run: dict) -> list[float]:
    """Host seconds of each iteration of a `run_cli` run, the first from the
    end of loading."""
    return [b - a for a, b in zip(run["load_end"] + run["stamps"][:-1], run["stamps"])]


class StopRun(Exception):
    """Raised by an on_step hook to interrupt a run."""


def flash_launches(forwards: int, backwards: int, per_forward: int = FLASH_ATTENTIONS_PER_FORWARD):
    return {**{name: 0 for name in KERNELS}, "attn_fwd": per_forward * forwards,
            "attn_bwd_dq": per_forward * backwards, "attn_bwd_dkv": per_forward * backwards}


def phase_recipes(device, ckpt: Path, out_dir: Path) -> dict:
    """Every SD1.x/2.x training option of the JAX trainer on the card:
    1. examples/unreal_config.yaml + unreal_prompts.yaml (Lion, cosine,
       rank 16, the 12-pair multi-resolution prompts: 512 px batch 3, 640 px
       batch 2, 768 px batch 1) through the CLI on the random full-width
       SD2.1 file of phase cli, UNREAL_ITERATIONS iterations, with
       save_state and ema_decay;
    2. the same run interrupted after iteration 3 and resumed from its
       newest snapshot (step_2), against run 1;
    3. ddpm, lms and euler_a on the SD1.5 bundle through train();
    4. the eight optimizers on run 1's LoRA tree, card against CPU;
    5. checkpoint_unet: one SD2.1 768 px step with it off and on;
    6. the knobs LECO_FLASH_BWD=xla and LECO_FLASH_CROSS=1 on SD1.5 steps.
    cuDNN runs deterministic algorithms here (a nondeterministic conv
    backward alone would move Lion's signs between two equal runs)."""
    import numpy as np
    import torch

    from leco_tpu_torch.lora import LoRASpec, read_safetensors
    from leco_tpu_torch.models import loader
    from leco_tpu_torch.ops.schedulers import create_noise_scheduler
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_sd15_bundle
    from leco_tpu_torch.train import checkpoint as ckpt_lib
    from leco_tpu_torch.train import trainer

    saved_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now
        print(f"recipes part {name}: {seconds[name]:.1f} s", flush=True)

    try:
        # ---- 1. the unreal recipe, uninterrupted
        run1_dir = out_dir / "unreal"
        run1 = run_cli(unreal_config(ckpt, run1_dir), out_dir / "unreal.yaml")
        result = run1["result"]
        losses = result["losses"]
        check(len(losses) == UNREAL_ITERATIONS and all(np.isfinite(losses)), f"unreal losses {losses}")
        records = [json.loads(ln) for ln in (run1_dir / "metrics.jsonl").read_text().splitlines()]
        lr = 1e-4
        for r in records:  # the cosine schedule, eta_min lr / 100
            want = lr / 100 + (lr - lr / 100) * 0.5 * (1 + math.cos(math.pi * r["iteration"]
                                                                 / UNREAL_ITERATIONS))
            check(abs(r["lr"] - want) <= 1e-6 * want, f"lr {r['lr']} != cosine {want}")
        tsto = [r["timesteps_to"] for r in records]
        want = flash_launches(sum(t + 2 for t in tsto), UNREAL_ITERATIONS)
        check(run1["launches"] == want, f"unreal launches {run1['launches']} != {want}")
        for stem, tree in (("unreal_last", result["lora"]), ("unreal_last_ema", result["ema"])):
            state, _ = read_safetensors(run1_dir / f"{stem}.safetensors")
            for k, v in tree.items():
                layer, part = k.rsplit(".", 1)
                key = "lora_unet_" + layer.replace(".", "_") + f".{part}.weight"
                check(torch.equal(state[key], v.to(torch.bfloat16)), f"{stem}: {key} differs")
        for it in range(UNREAL_PER_STEPS, UNREAL_ITERATIONS - 1, UNREAL_PER_STEPS):
            for stem in (f"unreal_{it}steps", f"unreal_{it}steps_ema"):
                state, _ = read_safetensors(run1_dir / f"{stem}.safetensors")
                check(len(state) == len(result["lora"]) * 3 // 2, f"{stem}: {len(state)} tensors")
        check(ckpt_lib.latest_step(run1_dir / "state") == UNREAL_ITERATIONS - 2,
              "the newest snapshot")
        per_iter = iteration_seconds(run1)
        resolutions = [r["resolution"][0] for r in records]
        print(f"recipes unreal: seconds per iteration {json.dumps(per_iter)} (timesteps_to "
              f"{tsto}, resolutions {resolutions}), peak {run1['peak_mem_gb']:.2f} GiB",
              flush=True)
        out["unreal"] = {"losses": losses, "timesteps_to": tsto, "resolutions": resolutions,
                         "launches": run1["launches"], "seconds": run1["seconds"],
                         "load_seconds": run1["load_end"][0] - run1["t0"],
                         "seconds_per_iteration": per_iter, "peak_mem_gb": run1["peak_mem_gb"],
                         "lora_tensors": len(result["lora"])}
        lap("unreal")

        # ---- 2. interrupted after iteration 3, then resumed from step_2
        run2_dir = out_dir / "unreal_resumed"

        def stop(i, loss):
            if i == 3:
                raise StopRun

        try:
            run_cli(unreal_config(ckpt, run2_dir), out_dir / "cut.yaml", on_step=stop)
            check(False, "the interrupted run was not interrupted")
        except StopRun:
            pass
        check(ckpt_lib.latest_step(run2_dir / "state") == 2, "the newest snapshot is not step_2")
        config = unreal_config(ckpt, run2_dir)
        config["train"]["resume"] = True
        run2 = run_cli(config, out_dir / "resume.yaml")
        resumed = run2["result"]["losses"]
        check(len(resumed) == UNREAL_ITERATIONS - 3, f"resumed losses {resumed}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[3:]))
        check(loss_err <= RTOL_RESUME, f"resumed losses {resumed} vs {losses[3:]}")
        last1, _ = read_safetensors(run1_dir / "unreal_last.safetensors")
        last2, _ = read_safetensors(run2_dir / "unreal_last.safetensors")
        period, _ = read_safetensors(run1_dir / f"unreal_{UNREAL_PER_STEPS}steps.safetensors")
        size = max(v.float().abs().max().item() for v in last1.values())
        w_err = max((last2[k].float() - v.float()).abs().max().item() for k, v in last1.items())
        control = max((period[k].float() - v.float()).abs().max().item() for k, v in last1.items())
        limit = RTOL_RESUME * size
        check(w_err <= limit, f"resumed weights differ by {w_err} > {limit}")
        check(control > limit, f"the weight limit {limit} passes run 1's "
                               f"{UNREAL_PER_STEPS}-step weights ({control})")
        bitwise = all(torch.equal(last2[k], v) for k, v in last1.items())
        print(f"recipes resume: losses {resumed} vs {losses[3:]}, weights error {w_err} "
              f"(limit {limit}, control {control}), bitwise {bitwise}", flush=True)
        out["resume"] = {"losses": resumed, "loss_rel_err": loss_err, "weight_err": w_err,
                         "weight_limit": limit, "weight_control": control, "bitwise": bitwise,
                         "launches": run2["launches"]}
        lap("resume")

        # ---- 4. the eight optimizers on run 1's LoRA tree, card against CPU
        out["optimizers"] = optimizer_checks(result["lora"], device)
        del result, run1, run2
        torch.cuda.empty_cache()
        lap("optimizers")

        # ---- 5. checkpoint_unet: SD2.1, 768 px, batch 1
        spec = LoRASpec(rank=16, alpha=1.0, network_type="lierla")
        models = loader.load_models(str(ckpt), v2=True, v_pred=True, weight_dtype=torch.bfloat16,
                                    lora_spec=spec, attn_backend="flash", device=device)
        bundle = trainer.ModelBundle.from_loaded(models, spec, device)
        pack = trainer.build_pack(trainer.encode_prompt_pairs(
            [PromptSettings.from_dict({"target": "realistic", "resolution": CKPT_RESOLUTION})],
            bundle.encode_fn)[0])
        del models
        bundle.free_text_encoder()
        runs = {}
        for name, on, seed in (("off", False, 0), ("on", True, 0), ("control", False, 1)):
            bundle.unet.checkpoint_unet = on
            runs[name] = one_step(bundle, pack, CKPT_RESOLUTION, seed)
        off, on = runs["off"], runs["on"]
        check(on["loss"] == off["loss"], f"checkpoint_unet loss {on['loss']} != {off['loss']}")
        gate = grads_gate(on["grads"], off["grads"], runs["control"]["grads"], RTOL_CKPT_GRADS,
                          "checkpoint_unet")
        want_off = flash_launches(STEP_TIMESTEPS_TO + 2, 1)
        want_on = {**want_off, "attn_fwd": want_off["attn_fwd"] + FLASH_ATTENTIONS_PER_FORWARD}
        check(off["launches"] == want_off, f"launches off {off['launches']} != {want_off}")
        check(on["launches"] == want_on, f"launches on {on['launches']} != {want_on}")
        print(f"recipes checkpoint_unet: peak {off['peak_mem_gb']:.2f} GiB off, "
              f"{on['peak_mem_gb']:.2f} GiB on; step {off['seconds']:.3f} s off, "
              f"{on['seconds']:.3f} s on", flush=True)
        out["checkpoint_unet"] = {
            "loss": on["loss"], **gate, "launches_off": off["launches"],
            "launches_on": on["launches"], "peak_mem_gb_off": off["peak_mem_gb"],
            "peak_mem_gb_on": on["peak_mem_gb"], "step_s_off": off["seconds"],
            "step_s_on": on["seconds"]}
        del bundle, pack, runs, off, on
        torch.cuda.empty_cache()
        lap("checkpoint_unet")

        # ---- 3. the schedulers, and 6. the knobs, on the SD1.5 bundle
        bundle = make_sd15_bundle(dtype=torch.bfloat16, seed=0, device=device)
        out["schedulers"] = {kind: scheduler_run(bundle, kind, out_dir / kind)
                             for kind in ("ddpm", "lms", "euler_a")}
        lap("schedulers")
        bundle.scheduler = create_noise_scheduler("ddim")
        out["knobs"] = knob_checks(bundle)
        del bundle
        torch.cuda.empty_cache()
        lap("knobs")
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
    return {**out, "part_seconds": seconds}


def one_step(bundle, pack, res: int, seed: int) -> dict:
    """One train step at STEP_TIMESTEPS_TO on latents from `seed`, its
    optimizer at lr 0 (the weights stay) -> loss, LoRA grads, launches, peak
    memory, seconds."""
    import torch

    from leco_tpu_torch.train import trainer

    step = trainer.make_train_step(
        bundle, torch.optim.SGD(list(bundle.lora_params.values()), lr=0.0), 50)
    gen = torch.Generator(bundle.device)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss = step(pack, 1.0, 1.0, STEP_TIMESTEPS_TO, height=res, width=res, generator=gen)
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": lora_grads(bundle), "launches": launches(),
            "seconds": time.perf_counter() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def scheduler_run(bundle, kind: str, save_dir: Path) -> dict:
    """2 iterations of train() with `kind` on the SD1.5 bundle."""
    import numpy as np

    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.ops.schedulers import create_noise_scheduler
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train.trainer import train

    iterations = 2
    bundle.scheduler = create_noise_scheduler(kind)
    config = RootConfig.from_dict({
        "prompts_file": "(in-code)", "pretrained_model": {"name_or_path": "(random sd15)"},
        "train": {"precision": "bfloat16", "noise_scheduler": kind, "iterations": iterations,
                  "lr": 1e-4, "optimizer": "adamw", "max_denoising_steps": 50, "seed": 0},
        "save": {"name": kind, "path": str(save_dir), "per_steps": 0, "precision": "bfloat16"},
    })
    encode_fn = bundle.encode_fn
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = train(config, [PromptSettings.from_dict(
            {"target": "van gogh", "resolution": SD15_RESOLUTION})], bundle)
    finally:
        bundle.encode_fn = encode_fn
    import torch

    torch.cuda.synchronize()
    counts = launches()
    records = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
    tsto = [r["timesteps_to"] for r in records]
    check(len(result["losses"]) == iterations and all(np.isfinite(result["losses"])),
          f"{kind}: losses {result['losses']}")
    want = flash_launches(sum(t + 2 for t in tsto), iterations)
    check(counts == want, f"{kind}: launches {counts} != {want}")
    return {"losses": result["losses"], "timesteps_to": tsto, "launches": counts,
            "seconds": time.perf_counter() - t0}


def knob_checks(bundle) -> dict:
    """LECO_FLASH_BWD=xla: no backward kernel, the grads of the default
    step; LECO_FLASH_CROSS=1: cross-attention through the forward kernel."""
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train import trainer

    pack = trainer.build_pack(trainer.encode_prompt_pairs(
        [PromptSettings.from_dict({"target": "van gogh", "resolution": SD15_RESOLUTION})],
        bundle.encode_fn)[0])
    default = one_step(bundle, pack, SD15_RESOLUTION, 0)
    control = one_step(bundle, pack, SD15_RESOLUTION, 1)
    with environ({"LECO_FLASH_BWD": "xla"}):
        plain_bwd = one_step(bundle, pack, SD15_RESOLUTION, 0)
    want = flash_launches(STEP_TIMESTEPS_TO + 2, 0)
    check(plain_bwd["launches"] == want, f"LECO_FLASH_BWD=xla launches {plain_bwd['launches']}")
    check(plain_bwd["loss"] == default["loss"], "LECO_FLASH_BWD=xla changed the loss")
    gate = grads_gate(plain_bwd["grads"], default["grads"], control["grads"], RTOL_GRAD,
                      "LECO_FLASH_BWD=xla")
    with environ({"LECO_FLASH_CROSS": "1"}):
        cross = one_step(bundle, pack, SD15_RESOLUTION, 0)
    # every transformer at levels 0-2 adds its cross-attention (Nk 77)
    want = flash_launches(STEP_TIMESTEPS_TO + 2, 1, per_forward=2 * FLASH_ATTENTIONS_PER_FORWARD)
    check(cross["launches"] == want, f"LECO_FLASH_CROSS=1 launches {cross['launches']} != {want}")
    check(math.isfinite(cross["loss"]), f"LECO_FLASH_CROSS=1 loss {cross['loss']}")
    print(f"recipes knobs: LECO_FLASH_BWD=xla grads error {gate['grad_err']} (limit "
          f"{gate['grad_limit']}, control {gate['grad_control']}); LECO_FLASH_CROSS=1 loss "
          f"{cross['loss']} vs {default['loss']}", flush=True)
    return {"flash_bwd_xla": {**gate, "launches": plain_bwd["launches"],
                              "peak_mem_gb": plain_bwd["peak_mem_gb"],
                              "peak_mem_gb_default": default["peak_mem_gb"]},
            "flash_cross": {"loss": cross["loss"], "default_loss": default["loss"],
                            "launches": cross["launches"]}}


def optimizer_checks(tree: dict, device) -> dict:
    """Each optimizer OPTIMIZER_STEPS steps on `tree` (CPU tensors) with
    seeded gradients, on the card and on the CPU: the card's weights within
    RTOL_OPTIMIZER x max|w| of the CPU's (a control: the weights moved by
    more than that); the device time of one step() on the card and its time
    by CUDA events, and the 8-bit states' bytes."""
    import torch

    from leco_tpu_torch.kernels import timing
    from leco_tpu_torch.train.optim import get_lr_schedule, get_optimizer

    rows = {}
    for name, lr, args in OPTIMIZERS:
        weights = {}
        opts = {}
        for dev in ("cpu", device):
            params = [torch.nn.Parameter(v.detach().float().clone().to(dev))
                      for v in tree.values()]
            opt = get_optimizer(name, params, lr, args)
            lr_at = get_lr_schedule("cosine", lr, OPTIMIZER_STEPS)
            gen = torch.Generator()
            gen.manual_seed(0)
            for j in range(OPTIMIZER_STEPS):
                for p in params:
                    p.grad = torch.randn(p.shape, generator=gen).to(dev)
                opt.param_groups[0]["lr"] = lr_at(j)
                opt.step()
            weights[str(dev)] = [p.detach().cpu() for p in params]
            opts[str(dev)] = opt
        cpu, card = weights["cpu"], weights[str(device)]
        start = [v.float() for v in tree.values()]
        size = max(w.abs().max().item() for w in cpu)
        err = max((a - b).abs().max().item() for a, b in zip(card, cpu))
        moved = max((a - b).abs().max().item() for a, b in zip(cpu, start))
        limit = RTOL_OPTIMIZER * size
        check(err <= limit, f"{name}: card weights differ from the CPU's by {err} > {limit}")
        check(moved > limit, f"{name}: the weights moved by {moved}, not past the limit")
        card_opt = opts[str(device)]
        row = {"err": err, "limit": limit, "moved": moved,
               # the step's kernels, and the step by CUDA events (host included)
               "device_ms": timing.device_ms(card_opt.step, calls=3, repeats=3, warmup=1),
               "ms": time_ms(card_opt.step),
               "bitwise": all(torch.equal(a, b) for a, b in zip(card, cpu))}
        if hasattr(card_opt, "state_bytes"):
            row["state_bytes"] = card_opt.state_bytes()
        rows[name] = row
        print(f"recipes optimizer {name}: {json.dumps(row)}", flush=True)
    return {"leaves": len(tree), "elements": sum(v.numel() for v in tree.values()),
            "steps": OPTIMIZER_STEPS, **rows}


def four_phase_convs(x, w, bias):
    """The JAX package's `_phase_conv_up2x` as it is written (lora.py:
    347-381): four convs, each a 2x2 phase kernel over x padded on two
    sides, interleaved by a stack and a transpose (for timing only)."""
    import torch
    import torch.nn.functional as F

    n, _, h, wd = x.shape
    outs = []
    for a in (0, 1):
        rows = (w[:, :, 0], w[:, :, 1] + w[:, :, 2]) if a == 0 else (w[:, :, 0] + w[:, :, 1], w[:, :, 2])
        ka = torch.stack(rows, dim=2)
        for b in (0, 1):
            cols = (ka[..., 0], ka[..., 1] + ka[..., 2]) if b == 0 else (ka[..., 0] + ka[..., 1], ka[..., 2])
            pad = (1 - b, b, 1 - a, a)
            outs.append(F.conv2d(F.pad(x, pad), torch.stack(cols, dim=3)))
    z = torch.stack(outs).reshape(2, 2, n, -1, h, wd).permute(2, 3, 4, 0, 5, 1)
    return z.reshape(n, -1, 2 * h, 2 * wd) + bias[None, :, None, None]


def upsampler_times(device) -> list:
    """The phase-conv upsampler (the port's, and the JAX package's literal
    four convs) against materialise + F.conv2d at SD1.5's three upsampler
    shapes, bf16: the error of each against the fp32 conv of the
    materialised input, and `device_ms` of each."""
    import torch
    import torch.nn.functional as F

    from leco_tpu_torch.kernels import timing
    from leco_tpu_torch.lora import LoRAConv2d

    gen = torch.Generator(device)
    gen.manual_seed(5)
    rows = []
    for b, c, h in UPSAMPLER_SHAPES:
        conv = LoRAConv2d(c, c, 3, padding=1, pre_upsample=True).to(device)
        conv.weight.data = (torch.randn((c, c, 3, 3), generator=gen, device=device)
                            / math.sqrt(9 * c)).to(torch.bfloat16)
        conv.bias.data = torch.randn((c,), generator=gen, device=device).to(torch.bfloat16)
        x = torch.randn((b, c, h, h), generator=gen, device=device).to(torch.bfloat16)

        def materialised():
            return F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), conv.weight,
                            conv.bias, 1, 1)

        with torch.no_grad():
            ref = F.conv2d(F.interpolate(x.float(), scale_factor=2.0, mode="nearest"),
                           conv.weight.float(), conv.bias.float(), 1, 1)
            size = ref.abs().max().item()
            forms = {"phase": lambda: conv(x),
                     "four_convs": lambda: four_phase_convs(x, conv.weight, conv.bias),
                     "materialised": materialised}
            errs = {name: (fn().float() - ref).abs().max().item() for name, fn in forms.items()}
            for name, err in errs.items():
                check(err <= RTOL_FUSED * size, f"upsampler {name} at {(b, c, h)}: {err} > "
                                                f"{RTOL_FUSED} x {size}")
            row = {"shape": [b, c, h, h], "max_abs_err": errs, "max_abs_ref": size,
                   **{f"{name}_device_ms": timing.device_ms(fn) for name, fn in forms.items()}}
        print(f"infer upsampler {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def phase_infer(device, ckpt: Path, out_dir: Path) -> dict:
    """Inference and eval at full width: phase cli's random SD2.1 file and
    the LoRA its default run trained, through `leco_tpu_torch.infer` (bf16,
    512 px, 20 DDIM steps, guidance 7, cuDNN deterministic):
    1. the LoRA read by `load_lora_weights`, and from a copy whose `.alpha`
       is doubled and `lora_up` halved, read under the spec: the same tree;
    2. the A/B at -1/0/+1 (`ab_compare`) with exact launch counts, 0 equal
       to a run without the LoRA, -1 and +1 different from it, the copy's
       tree giving the +1 latents;
    3. the list form against the single form (RTOL_COMPOSE, a control);
    4. one generation with LECO_FLASH_PACKED=1, exact packed launches;
    5. a random full-width SD VAE decoder: `decode_latents` to uint8
       (1, 512, 512, 3); a random CLIP ViT-L/14 dual encoder: the CLIP
       score, and `erased_concept_delta` over CLIP_SEEDS;
    6. the phase-conv upsampler against materialise + F.conv2d."""
    import numpy as np
    import torch

    from leco_tpu_torch import infer, testing
    from leco_tpu_torch.eval import CLIPScorer, erased_concept_delta
    from leco_tpu_torch.lora import (
        LoRASpec,
        fold_lora_params,
        load_lora_weights,
        lora_layers,
        lora_parameters,
        read_safetensors,
        scale_lora_tree,
        write_safetensors,
    )
    from leco_tpu_torch.models import loader
    from leco_tpu_torch.utils import yaml_subset

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    saved_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        net = yaml_subset.load(REPO / "examples" / "config.yaml")["network"]
        spec = LoRASpec(rank=net["rank"], alpha=net["alpha"], network_type=net["type"],
                        train_method=net["training_method"])
        models, load_s = synced(lambda: loader.load_models(
            str(ckpt), v2=True, v_pred=True, weight_dtype=torch.bfloat16, lora_spec=spec,
            attn_backend="flash", device=device))
        ref = lora_parameters(models.unet)

        # ---- 1. the trained LoRA, and a copy with its alpha rewritten
        lora_file = out_dir / "default" / "van_gogh_last.safetensors"
        lora = load_lora_weights(lora_file, ref, spec)
        check(lora.keys() == ref.keys(), "the LoRA file does not cover the model's layers")
        state, metadata = read_safetensors(lora_file)
        for k in state:
            if k.endswith(".alpha"):
                state[k] = state[k] * 2
            elif k.endswith(".lora_up.weight"):
                state[k] = state[k] / 2
        copy = out_dir / "van_gogh_alpha2.safetensors"
        write_safetensors(copy, state, metadata)
        rescaled = load_lora_weights(copy, ref, spec)
        unscaled = load_lora_weights(copy, ref)  # the control: no rescale
        check(all(torch.equal(rescaled[k], v) for k, v in lora.items()),
              "the alpha-2 copy read under the spec is not the LoRA")
        check(not all(torch.equal(unscaled[k], v) for k, v in lora.items()),
              "the alpha-2 copy read without the spec is the LoRA")

        # ---- 2. the A/B grid
        gen = infer.GenerationConfig(height=512, width=512, num_inference_steps=INFER_STEPS,
                                     guidance_scale=7.0, seed=0)
        plain, first_s = synced(lambda: infer.generate_latents(models, INFER_PROMPT, gen=gen))
        reset_launches()
        grid, ab_s = synced(lambda: infer.ab_compare(models, lora, INFER_PROMPT,
                                                     multipliers=INFER_MULTIPLIERS, gen=gen))
        counts = launches()
        want = flash_launches(len(INFER_MULTIPLIERS) * INFER_STEPS, 0)
        check(counts == want, f"A/B launches {counts} != {want}")
        for m, lat in grid.items():
            check(tuple(lat.shape) == (1, 4, 64, 64) and bool(torch.isfinite(lat).all()),
                  f"latents at {m}: {tuple(lat.shape)}, finite {bool(torch.isfinite(lat).all())}")
        check(torch.equal(grid[0.0], plain), "multiplier 0 is not the run without the LoRA")
        moved = {m: (grid[m] - plain).abs().max().item() for m in (-1.0, 1.0)}
        check(all(v > 0 for v in moved.values()), f"-1 / +1 equal to multiplier 0: {moved}")
        again = infer.generate_latents(models, INFER_PROMPT, gen=gen, lora=rescaled)
        check(torch.equal(again, grid[1.0]), "the alpha-2 copy's latents differ at +1")
        per_image = ab_s / len(INFER_MULTIPLIERS)
        out["ab"] = {"launches": counts, "seconds": ab_s, "seconds_per_image": per_image,
                     "seconds_per_ddim_step": per_image / INFER_STEPS,
                     "first_image_seconds": first_s, "load_seconds": load_s,
                     "max_abs_moved_from_0": moved}

        # ---- 3. the list form against the single form
        weights = {f"{n}.weight": m.weight.float() for n, m in lora_layers(models.unet)}
        folded = fold_lora_params(weights, lora, spec)
        delta_rms = math.sqrt(sum(((folded[k] - w) ** 2).sum().item() for k, w in weights.items())
                              / sum(w.numel() for w in weights.values()))
        w_rms = math.sqrt(sum((w ** 2).sum().item() for w in weights.values())
                          / sum(w.numel() for w in weights.values()))
        factor = 2.0 ** round(math.log2(COMPOSE_WEIGHT_SHARE * w_rms / delta_rms))
        strong = scale_lora_tree(lora, factor)
        single = infer.generate_latents(models, INFER_PROMPT, gen=gen, lora=strong)
        listed = infer.generate_latents(models, INFER_PROMPT, gen=gen,
                                        lora=[(strong, 0.5), (strong, 0.5)], spec=spec)
        control = infer.generate_latents(models, INFER_PROMPT, gen=gen, lora=[(strong, 0.5)],
                                         spec=spec)
        effect = (single - plain).abs().max().item()
        err = (listed - single).abs().max().item()
        control_err = (control - single).abs().max().item()
        limit = RTOL_COMPOSE * effect
        check(err <= limit, f"list form vs single: {err} > {RTOL_COMPOSE} x {effect}")
        check(control_err > limit, f"the compose limit {limit} passes [(L, 0.5)] ({control_err})")
        out["compose"] = {"factor": factor, "weight_rms": w_rms, "delta_rms": delta_rms,
                          "effect": effect, "err": err, "limit": limit,
                          "control_err": control_err}
        del weights, folded, strong

        # ---- 4. the packed route
        with environ({"LECO_FLASH_PACKED": "1"}):
            reset_launches()
            packed, packed_s = synced(lambda: infer.generate_latents(
                models, INFER_PROMPT, gen=gen, lora=lora))
            packed_counts = launches()
        want = {**{name: 0 for name in KERNELS},
                PACKED: FLASH_ATTENTIONS_PER_FORWARD * INFER_STEPS}
        check(packed_counts == want, f"packed launches {packed_counts} != {want}")
        check(bool(torch.isfinite(packed).all()), "non-finite packed latents")
        out["packed"] = {"launches": packed_counts, "seconds": packed_s,
                         "max_abs_diff_vs_3d": (packed - grid[1.0]).abs().max().item()}

        # ---- 5. the VAE decoder and the CLIP scorer at full width
        (_, write_s) = synced(lambda: (
            testing.write_vae_dir(out_dir / "vae_model", seed=0, device=device),
            testing.write_clip_dir(out_dir / "clip", seed=0, dtype=torch.float16,
                                   device=device)))
        vae = loader.load_vae_decoder(str(out_dir / "vae_model"), torch.float32, device)
        scorer = CLIPScorer.from_pretrained(str(out_dir / "clip"), device=device)
        decodes, scores = [], []
        for _ in range(3):
            images, t = synced(lambda: infer.decode_latents(models, grid[0.0], vae))
            decodes.append(t)
            score, t = synced(lambda: scorer.score(images, [INFER_PROMPT]))
            scores.append(t)
        check(images.dtype == np.uint8 and images.shape == (1, 512, 512, 3),
              f"decoded {images.dtype} {images.shape}")
        check(len(np.unique(images)) > 16, "the decoded image is flat")
        check(score.shape == (1,) and bool(np.isfinite(score).all()), f"CLIP score {score}")
        # random towers: the cosine before the clip at 0 shows the score ran
        cosine = torch.nn.functional.cosine_similarity(
            scorer.image_embeds(images), scorer.text_embeds([INFER_PROMPT])).item()

        def generate_fn(prompt, seed, multiplier):
            return infer.generate_latents(models, prompt, gen=dataclasses.replace(gen, seed=seed),
                                          lora=lora, multiplier=multiplier)

        erased, erased_s = synced(lambda: erased_concept_delta(
            scorer, lambda lat: infer.decode_latents(models, lat, vae), generate_fn,
            INFER_PROMPT, seeds=CLIP_SEEDS))
        check(all(math.isfinite(v) for v in erased.values()), f"erased_concept_delta {erased}")
        out["eval"] = {"write_seconds": write_s, "vae_decode_ms": statistics.median(decodes) * 1e3,
                       "clip_score_ms": statistics.median(scores) * 1e3, "clip_score": float(score[0]),
                       "clip_cosine": cosine,
                       "erased_concept_delta": erased, "erased_seconds": erased_s}
        del models, vae, scorer
        torch.cuda.empty_cache()

        # ---- 6. the phase-conv upsampler
        out["upsampler"] = upsampler_times(device)
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"infer ({smi}): {out['ab']['seconds_per_ddim_step']:.4f} s per DDIM step, "
          f"{out['ab']['seconds_per_image']:.3f} s per image (512 px, {INFER_STEPS} steps, "
          f"CFG batch 2), VAE decode {out['eval']['vae_decode_ms']:.1f} ms, CLIP score "
          f"{out['eval']['clip_score_ms']:.1f} ms", flush=True)
    return {**out, "nvidia_smi": smi}


def phase_xl(device, out_dir: Path) -> dict:
    """SDXL at full width (random weights from seed 0), cuDNN deterministic:
    1. a random SDXL single file (fp16, 2.57B UNet + CLIP-L + bigG) written
       tensor by tensor, its UNet's LDM keys checked against
       tests/fixtures/ldm_unet_keys_sdxl.txt;
    2. examples/config_xl.yaml + examples/prompts_xl.yaml (1024 px, batch 1,
       bf16, rank-4 lierla, DDIM, AdamW, the flash kernels) through
       `train_lora_xl.main()`, XL_ITERATIONS iterations with seed 0: finite
       losses, exact flash launches, the saved file read back equal;
    3. one more iteration with dynamic_crops and one with checkpoint_unet,
       through train() on a second load of the file, with peak memory;
    4. one 1024 px bf16 UNet forward at the inner batch 2: the kernels
       against plain attention, the fused knobs on against off (with their
       launches), the packed route bitwise the 3-d route;
    5. the trained LoRA through `ab_compare` at 1024 px, XL_INFER_STEPS
       DDIM steps, guidance 7, exact launches; a full-width SDXL VAE decode
       (scaling factor 0.13025) to uint8 (1, 1024, 1024, 3)."""
    import numpy as np
    import torch

    from leco_tpu_torch import infer, testing
    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.lora import (
        LoRASpec,
        count_lora_modules,
        load_lora_weights,
        lora_parameters,
        read_safetensors,
    )
    from leco_tpu_torch.models import loader
    from leco_tpu_torch.models.vae import sdxl_vae_config
    from leco_tpu_torch.prompts import load_prompts_from_yaml
    from leco_tpu_torch.train import diffusion as diff
    from leco_tpu_torch.train.trainer import ModelBundle, train
    from leco_tpu_torch.utils import yaml_subset

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t

    saved_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        # ---- 1. the file
        ckpt, write_s = synced(lambda: testing.write_sdxl_single_file(
            out_dir / XL_CHECKPOINT, seed=0, dtype=torch.float16, device=device))
        shapes = safetensors_shapes(ckpt)
        unet_keys = {k: v for k, v in shapes.items() if k.startswith("model.diffusion_model.")}
        fixture = {}
        for line in (REPO / "tests" / "fixtures" / "ldm_unet_keys_sdxl.txt").read_text() \
                .splitlines():
            key, shape = line.split()
            fixture[key] = tuple(int(x) for x in shape.split(","))
        check(unet_keys == fixture, "the written UNet's LDM keys and shapes are not SDXL's: "
              f"{sorted(set(unet_keys) ^ set(fixture))[:5]}")
        check(sum(k.startswith("conditioner.embedders.1.model.transformer.resblocks.")
                  and k.endswith(".ln_1.weight") for k in shapes) == 32, "bigG resblocks")
        gib = ckpt.stat().st_size / 2**30
        print(f"xl checkpoint: {gib:.2f} GiB, {len(shapes)} tensors, written in "
              f"{write_s:.1f} s", flush=True)
        out["file"] = {"gib": gib, "tensors": len(shapes), "write_seconds": write_s}

        # ---- 2. the recipe through the CLI
        config = yaml_subset.load(REPO / "examples" / "config_xl.yaml")
        config["prompts_file"] = str(REPO / "examples" / "prompts_xl.yaml")
        config["pretrained_model"]["name_or_path"] = str(ckpt)
        config["train"].update(iterations=XL_ITERATIONS, seed=0)
        save_dir = out_dir / "xl_out"
        config["save"]["path"] = str(save_dir)
        run = run_cli(config, out_dir / "config_xl.yaml", cli="train_lora_xl")
        result, counts = run["result"], run["launches"]
        losses = result["losses"]
        check(len(losses) == XL_ITERATIONS and all(math.isfinite(v) for v in losses),
              f"xl losses {losses}")
        records = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
        tsto = [r["timesteps_to"] for r in records]
        check(all(r["resolution"] == [XL_RESOLUTION] * 2 for r in records), "xl resolution")
        want = flash_launches(sum(t + 2 for t in tsto), XL_ITERATIONS, XL_FLASH_PER_FORWARD)
        check(counts == want, f"xl launches {counts} != {want}")
        name = config["save"]["name"]
        state, metadata = read_safetensors(save_dir / f"{name}_last.safetensors")
        n_layers = count_lora_modules(result["lora"])
        check(len(state) == 3 * n_layers, f"xl: {len(state)} tensors, {n_layers} layers")
        for k, v in result["lora"].items():
            layer, part = k.rsplit(".", 1)
            key = "lora_unet_" + layer.replace(".", "_") + f".{part}.weight"
            check(torch.equal(state[key], v.to(torch.bfloat16)), f"xl: saved {key} differs")
        per_iter = iteration_seconds(run)
        print(f"xl cli: seconds per iteration {json.dumps(per_iter)} (timesteps_to {tsto}), "
              f"load {run['load_end'][0] - run['t0']:.1f} s, peak {run['peak_mem_gb']:.2f} GiB",
              flush=True)
        out["cli"] = {"losses": losses, "timesteps_to": tsto, "launches": counts,
                      "load_seconds": run["load_end"][0] - run["t0"],
                      "seconds_per_iteration": per_iter, "peak_mem_gb": run["peak_mem_gb"],
                      "lora_layers": n_layers}
        del run, result, state

        # ---- 3. dynamic_crops and checkpoint_unet, one iteration each
        net = config["network"]
        spec = LoRASpec(rank=net["rank"], alpha=net["alpha"], network_type=net["type"],
                        train_method=net["training_method"])
        models, load_s = synced(lambda: loader.load_models_xl(
            str(ckpt), weight_dtype=torch.bfloat16, lora_spec=spec, attn_backend="flash",
            device=device, checkpoint_unet=False))
        prompts = load_prompts_from_yaml(REPO / "examples" / "prompts_xl.yaml")
        for variant in ("dynamic_crops", "checkpoint_unet"):
            one = {**config, "train": {**config["train"], "iterations": 1,
                                       "checkpoint_unet": variant == "checkpoint_unet"},
                   "save": {**config["save"], "path": str(out_dir / f"xl_{variant}")}}
            settings = [dataclasses.replace(p, dynamic_crops=variant == "dynamic_crops")
                        for p in prompts]
            bundle = ModelBundle.from_loaded(models, spec, device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            extra, seconds = synced(lambda: train(RootConfig.from_dict(one), settings, bundle))
            models.unet.checkpoint_unet = False
            rec = json.loads((out_dir / f"xl_{variant}" / "metrics.jsonl").read_text()
                             .splitlines()[0])
            counts = launches()
            forwards = rec["timesteps_to"] + 2 + (variant == "checkpoint_unet")
            want = flash_launches(forwards, 1, XL_FLASH_PER_FORWARD)
            check(counts == want, f"xl {variant} launches {counts} != {want}")
            check(all(math.isfinite(v) for v in extra["losses"]), f"xl {variant} loss")
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"xl {variant}: {seconds:.2f} s (timesteps_to {rec['timesteps_to']}), "
                  f"peak {peak:.2f} GiB", flush=True)
            out[variant] = {"loss": extra["losses"][0], "timesteps_to": rec["timesteps_to"],
                            "seconds": seconds, "peak_mem_gb": peak, "launches": counts}
            del bundle, extra

        # ---- 4. one full-width forward, three pairs
        gen = torch.Generator(device)
        gen.manual_seed(5)
        lat = XL_RESOLUTION // 8
        unet = models.unet
        x = torch.randn((2, 4, lat, lat), generator=gen, device=device)
        ctx = torch.randn((2, 77, unet.cfg.cross_attention_dim), generator=gen, device=device)
        time_ids = torch.from_numpy(diff.get_add_time_ids(XL_RESOLUTION, XL_RESOLUTION))
        added = {"text_embeds": torch.randn((2, testing.xl_pooled_dim(unet.cfg)),
                                            generator=gen, device=device),
                 "time_ids": time_ids.to(device).repeat(2, 1)}
        forward = {}
        with torch.no_grad():
            reset_launches()
            flash_out = unet(x, 501.0, ctx, added).float()
            torch.cuda.synchronize()
            flash_counts = launches()
            unet.set_attention_backend("xla")
            plain_out = unet(x, 501.0, ctx, added).float()
            unet.set_attention_backend("flash")
            with fused_knobs(True):
                reset_launches()
                fused_out = unet(x, 501.0, ctx, added).float()
                torch.cuda.synchronize()
                fused_counts = launches()
            with environ({"LECO_FLASH_PACKED": "1"}):
                reset_launches()
                packed_out = unet(x, 501.0, ctx, added).float()
                torch.cuda.synchronize()
                packed_counts = launches()
        size = plain_out.abs().max().item()
        for what, got, ref in (("flash vs plain", flash_out, plain_out),
                               ("knobs on vs off", fused_out, flash_out)):
            check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (2, 4, lat, lat),
                  f"xl forward {what}: shape {tuple(got.shape)}")
            err = (got - ref).abs().max().item()
            check(err <= RTOL_UNET * ref.abs().max().item(),
                  f"xl forward {what}: {err} > {RTOL_UNET} x {ref.abs().max().item()}")
            forward[what] = {"max_abs_err": err, "max_abs_ref": ref.abs().max().item()}
        check(torch.equal(packed_out, flash_out), "xl packed forward is not bitwise the 3-d one")
        check(flash_counts == flash_launches(1, 0, XL_FLASH_PER_FORWARD),
              f"xl forward launches {flash_counts}")
        want = {**flash_launches(1, 0, XL_FLASH_PER_FORWARD),
                **fused_launches("lierla", 1, 0, XL_CONVS, XL_UPSAMPLERS, XL_TRANSFORMERS,
                                 XL_FLASH_PER_FORWARD)}
        check(fused_counts == want, f"xl knobs-on launches {fused_counts} != {want}")
        want = {**{n: 0 for n in KERNELS}, PACKED: XL_FLASH_PER_FORWARD}
        check(packed_counts == want, f"xl packed launches {packed_counts} != {want}")
        out["forward"] = {**forward, "plain_max_abs": size, "fused_launches": fused_counts,
                          "packed_bitwise": True}
        del x, ctx, added, flash_out, plain_out, fused_out, packed_out

        # ---- 5. generation with the trained LoRA, and the VAE decode
        lora = load_lora_weights(save_dir / f"{name}_last.safetensors",
                                 lora_parameters(models.unet), spec)
        gen_cfg = infer.GenerationConfig(height=XL_RESOLUTION, width=XL_RESOLUTION,
                                         num_inference_steps=XL_INFER_STEPS, guidance_scale=7.0,
                                         seed=0)
        reset_launches()
        grid, ab_s = synced(lambda: infer.ab_compare(models, lora, XL_PROMPT,
                                                     multipliers=INFER_MULTIPLIERS, gen=gen_cfg))
        counts = launches()
        want = flash_launches(len(INFER_MULTIPLIERS) * XL_INFER_STEPS, 0, XL_FLASH_PER_FORWARD)
        check(counts == want, f"xl A/B launches {counts} != {want}")
        for m, lat_m in grid.items():
            check(tuple(lat_m.shape) == (1, 4, lat, lat) and bool(torch.isfinite(lat_m).all()),
                  f"xl latents at {m}")
        moved = {m: (grid[m] - grid[0.0]).abs().max().item() for m in (-1.0, 1.0)}
        check(all(v > 0 for v in moved.values()), f"xl -1 / +1 equal to 0: {moved}")
        per_image = ab_s / len(INFER_MULTIPLIERS)
        vae_dir, vae_write_s = synced(lambda: testing.write_vae_dir(
            out_dir / "sdxl_vae_model", sdxl_vae_config(), seed=0, device=device))
        vae = loader.load_vae_decoder(str(out_dir / "sdxl_vae_model"), torch.float32, device)
        check(vae.config.scaling_factor == 0.13025, "SDXL VAE scaling factor")
        decodes = []
        for _ in range(3):
            images, t = synced(lambda: infer.decode_latents(models, grid[1.0], vae))
            decodes.append(t)
        check(images.dtype == np.uint8 and images.shape == (1, XL_RESOLUTION, XL_RESOLUTION, 3),
              f"xl decoded {images.dtype} {images.shape}")
        check(len(np.unique(images)) > 16, "the decoded XL image is flat")
        out["infer"] = {"launches": counts, "seconds": ab_s, "seconds_per_image": per_image,
                        "seconds_per_ddim_step": per_image / XL_INFER_STEPS,
                        "load_seconds": load_s, "max_abs_moved_from_0": moved,
                        "vae_decode_ms": statistics.median(decodes) * 1e3}
        del models, vae, lora, grid
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"xl ({smi}): {out['infer']['seconds_per_ddim_step']:.4f} s per DDIM step, "
          f"{out['infer']['seconds_per_image']:.3f} s per image ({XL_RESOLUTION} px, "
          f"{XL_INFER_STEPS} steps, CFG batch 2), VAE decode "
          f"{out['infer']['vae_decode_ms']:.1f} ms", flush=True)
    return {**out, "nvidia_smi": smi}


def ti_step(bundle, handle, pack, seed: int) -> dict:
    """One textual-inversion step at STEP_TIMESTEPS_TO on latents from
    `seed`, its optimizer at lr 0 (the embedding stays) -> loss, the
    embedding's gradient, launches, peak memory, seconds."""
    import torch

    from leco_tpu_torch.train import textual_inversion as ti

    ids, slots, emb0 = ti.init_prompt_embedding(handle, TI_PROMPT)
    emb = torch.nn.Parameter(emb0.clone())
    step = ti.make_ti_train_step(bundle, handle, ids, slots, torch.optim.SGD([emb], lr=0.0), 50)
    gen = torch.Generator(bundle.device)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss = step(emb, pack, 1.0, 1.0, STEP_TIMESTEPS_TO, height=SD15_RESOLUTION,
                width=SD15_RESOLUTION, generator=gen)
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": {"emb": emb.grad.detach().float().clone()},
            "launches": launches(), "seconds": time.perf_counter() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def phase_ti(device, out_dir: Path) -> dict:
    """Textual-inversion erasure at full width, cuDNN deterministic:
    1. a random full-width SD1.5 diffusers checkpoint (fp16, CLIP-L, the
       synthetic tokenizer); examples/ti_config.yaml + prompts.yaml (van
       gogh, 512 px, batch 2, bf16, DDIM, AdamW at lr 5e-3, seed 0) through
       `train_ti.main()`, TI_ITERATIONS iterations with a save every
       iteration: finite losses, exact flash launches, the embedding moved,
       every saved `emb_params` read back equal to what was saved;
    2. one step's embedding gradient through the kernels against plain
       attention (RTOL_GRAD, a control on other latents), the same under
       LECO_FLASH_CROSS=1 (the cross-attention K/V carry the gradient into
       the text side through the backward pair), and checkpoint_unet on
       against off;
    3. the A/B at 512 px, TI_INFER_STEPS DDIM steps: the identity splice
       equal to the plain prompt, the trained embedding moving the latents;
    4. the native BPE engine: loaded, its ids the Python loop's."""
    import numpy as np
    import torch

    from leco_tpu_torch import infer, testing
    from leco_tpu_torch.models import loader
    from leco_tpu_torch.models.clip import sd1_text_config
    from leco_tpu_torch.models.tokenizer import CLIPTokenizer
    from leco_tpu_torch.models.unet import sd15_config
    from leco_tpu_torch.prompts import load_prompts_from_yaml, make_encode_fn
    from leco_tpu_torch.train import textual_inversion as ti
    from leco_tpu_torch.train import trainer
    from leco_tpu_torch.utils import yaml_subset

    saved_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out: dict = {}
    try:
        # ---- 1. the recipe through the CLI
        t0 = time.perf_counter()
        ckpt = testing.write_diffusers_checkpoint(out_dir / TI_CHECKPOINT, sd15_config(),
                                                  sd1_text_config(), seed=0,
                                                  dtype=torch.float16, device=device)
        out["write_seconds"] = time.perf_counter() - t0
        config = yaml_subset.load(REPO / "examples" / "ti_config.yaml")
        config["prompts_file"] = str(REPO / "examples" / "prompts.yaml")
        config["pretrained_model"]["name_or_path"] = str(ckpt)
        config["train"]["iterations"] = TI_ITERATIONS
        config["save"].update(path=str(out_dir / "ti"), per_steps=1)
        writes = []
        real_save = ti.save_embedding

        def recorded_save(file, emb, *args, **kwargs):
            writes.append((Path(file), emb.detach().cpu().clone()))
            real_save(file, emb, *args, **kwargs)

        ti.save_embedding = recorded_save
        try:
            run = run_cli(config, out_dir / "ti_config.yaml", cli="train_ti")
        finally:
            ti.save_embedding = real_save
        result, counts = run["result"], run["launches"]
        losses = result["losses"]
        check(len(losses) == TI_ITERATIONS and all(np.isfinite(losses)), f"ti losses {losses}")
        records = [json.loads(ln) for ln in (out_dir / "ti" / "metrics.jsonl").read_text()
                   .splitlines()]
        tsto = [r["timesteps_to"] for r in records]
        want = flash_launches(sum(t + 2 for t in tsto), 0)
        want.update(attn_bwd_dq=TI_FLASH_BACKWARDS * TI_ITERATIONS,
                    attn_bwd_dkv=TI_FLASH_BACKWARDS * TI_ITERATIONS)
        check(counts == want, f"ti launches {counts} != {want}")
        names = [p.name for p in result["saved"]]
        check(names == ["van_gogh_ti_1steps_ti.safetensors", "van_gogh_ti_ti.safetensors"],
              f"ti saves {names}")
        check([p for p, _ in writes] == result["saved"], "ti: saves not recorded")
        for path, emb in writes:
            got = ti.load_embedding(path)
            check(tuple(got.shape) == (2, 768) and torch.equal(got, emb.to(got.dtype)),
                  f"{path.name} does not read back what was saved")
        check(torch.equal(writes[-1][1], result["embedding"]), "the last save is not the result")
        per_iter = iteration_seconds(run)
        print(f"ti: seconds per iteration {json.dumps(per_iter)} (timesteps_to {tsto}), "
              f"peak {run['peak_mem_gb']:.2f} GiB, losses {losses}", flush=True)
        out["train"] = {"losses": losses, "timesteps_to": tsto, "launches": counts,
                        "seconds": run["seconds"],
                        "load_seconds": run["load_end"][0] - run["t0"],
                        "seconds_per_iteration": per_iter, "peak_mem_gb": run["peak_mem_gb"]}
        trained = result["embedding"]
        del run, result

        # ---- 2. one step's embedding gradient: kernels, plain, the knobs
        models = loader.load_models(str(ckpt), weight_dtype=torch.bfloat16,
                                    attn_backend="flash", device=device)
        handle = ti.TextEncoderHandle(model=models.text_encoder, tokenizer=models.tokenizer,
                                      device=device)
        bundle = trainer.ModelBundle(unet=models.unet, scheduler=models.scheduler, spec=None,
                                     device=device)
        (pair,) = trainer.encode_prompt_pairs(
            load_prompts_from_yaml(REPO / "examples" / "prompts.yaml"),
            make_encode_fn(models.tokenizer, models.text_encoder, device))
        pack = {"uncond_embeds": pair.unconditional,
                "ref_embeds": trainer.build_pack(pair)["ref_embeds"]}
        ids, slots, emb0 = ti.init_prompt_embedding(handle, TI_PROMPT)
        moved = (trained.to(device) - emb0).abs().max().item()
        check(moved > 0, "the trained embedding did not move from emb0")
        steps = {"kernels": ti_step(bundle, handle, pack, 0),
                 "control": ti_step(bundle, handle, pack, 1)}
        models.unet.set_attention_backend("xla")
        steps["plain"] = ti_step(bundle, handle, pack, 0)
        models.unet.set_attention_backend("flash")
        with environ({"LECO_FLASH_CROSS": "1"}):
            steps["cross"] = ti_step(bundle, handle, pack, 0)
            steps["cross_control"] = ti_step(bundle, handle, pack, 1)
        models.unet.checkpoint_unet = True
        steps["checkpoint_unet"] = ti_step(bundle, handle, pack, 0)
        models.unet.checkpoint_unet = False
        forwards = STEP_TIMESTEPS_TO + 2
        want = {"kernels": {**flash_launches(forwards, 0), "attn_bwd_dq": TI_FLASH_BACKWARDS,
                            "attn_bwd_dkv": TI_FLASH_BACKWARDS},
                "plain": flash_launches(0, 0)}
        want["control"] = want["kernels"]
        # cross-attention at levels 0-2 takes the kernels too, its backward
        # pair included (its K/V need the gradient)
        cross = 2 * FLASH_ATTENTIONS_PER_FORWARD
        want["cross"] = want["cross_control"] = {
            **flash_launches(forwards, 0, cross), "attn_bwd_dq": cross - 1,
            "attn_bwd_dkv": cross - 1}
        # the target pass's blocks run forward again in the backward
        want["checkpoint_unet"] = {**want["kernels"], "attn_fwd": want["kernels"]["attn_fwd"]
                                   + FLASH_ATTENTIONS_PER_FORWARD}
        for name, counts in want.items():
            check(steps[name]["launches"] == counts,
                  f"ti step {name}: launches {steps[name]['launches']} != {counts}")
        grads = {
            "kernels_vs_plain": grads_gate(steps["kernels"]["grads"], steps["plain"]["grads"],
                                           steps["control"]["grads"], RTOL_GRAD,
                                           "ti kernels vs plain"),
            "cross_vs_plain": grads_gate(steps["cross"]["grads"], steps["plain"]["grads"],
                                         steps["cross_control"]["grads"], RTOL_GRAD,
                                         "ti LECO_FLASH_CROSS=1 vs plain"),
            "checkpoint_unet": grads_gate(steps["checkpoint_unet"]["grads"],
                                          steps["kernels"]["grads"], steps["control"]["grads"],
                                          RTOL_CKPT_GRADS, "ti checkpoint_unet on vs off"),
        }
        check(steps["checkpoint_unet"]["loss"] == steps["kernels"]["loss"],
              "ti checkpoint_unet changed the loss")
        print(f"ti grads: {json.dumps(grads)}; peak {steps['kernels']['peak_mem_gb']:.2f} GiB, "
              f"{steps['checkpoint_unet']['peak_mem_gb']:.2f} with checkpoint_unet", flush=True)
        out["step"] = {"grads": grads, "embedding_moved": moved,
                       **{name: {k: v for k, v in step.items() if k != "grads"}
                          for name, step in steps.items()}}
        del steps

        # ---- 3. the A/B: identity splice and trained embedding
        gen = infer.GenerationConfig(height=SD15_RESOLUTION, width=SD15_RESOLUTION,
                                     num_inference_steps=TI_INFER_STEPS)
        with torch.no_grad():
            identity = ti.encode_spliced(handle, ids, slots, emb0)
            erased = ti.encode_spliced(handle, ids, slots, trained.to(device))
        reset_launches()
        t0 = time.perf_counter()
        plain = infer.generate_latents(models, TI_PROMPT, "", gen)
        torch.cuda.synchronize()
        image_seconds = time.perf_counter() - t0
        same = infer.generate_latents(models, TI_PROMPT, "", gen, positive_embeds=identity)
        other = infer.generate_latents(models, TI_PROMPT, "", gen, positive_embeds=erased)
        counts = launches()
        want = flash_launches(3 * TI_INFER_STEPS, 0)
        check(counts == want, f"ti A/B launches {counts} != {want}")
        check(torch.equal(same, plain), "the identity splice does not generate the plain image")
        distance = (other - plain).abs().max().item()
        check(bool(torch.isfinite(other).all()) and distance > 0,
              f"the trained embedding does not move the latents ({distance})")
        print(f"ti A/B: identity bitwise the plain prompt, trained embedding moves the "
              f"latents by {distance:.4f}; {image_seconds:.3f} s per image", flush=True)
        out["ab"] = {"identity_bitwise": True, "trained_max_abs_move": distance,
                     "seconds_per_image": image_seconds, "launches": counts}
        del models, bundle, handle

        # ---- 4. the native BPE engine against the Python merge loop
        tok_dir = ckpt / "tokenizer"
        native_tok = CLIPTokenizer.from_pretrained(str(tok_dir))
        with environ({"LECO_TPU_NATIVE": "0"}):
            python_tok = CLIPTokenizer.from_pretrained(str(tok_dir))
        check(native_tok._native is not None, "the native BPE engine did not load")
        prompts = [TI_PROMPT, "", "cat ears, realistic, real life", "1girl instagram zebra"]
        check(bool((native_tok(prompts) == python_tok(prompts)).all()),
              "native BPE ids differ from the Python loop's")
        print("ti native BPE: loaded, ids equal to the Python merge loop's", flush=True)
        out["native_bpe"] = {"loaded": True, "ids_equal": True}
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
    return out


# ---------------------------------------------------------------------------
# phase parallel: data, tensor and spatial parallelism (leco_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# SD1.5 at 512 px, the self-attention levels (tokens, head dim) and the sp
# sizes whose shards the kernels take: forward and dQ at Nq = N / sp against
# Nk = N, dK/dV at Nk = N / sp against Nq = N; the forward at the inner
# loop's BH = 2 x 8 heads, the backward pair at the target's BH = 8
PARALLEL_LEVELS = ((4096, 40), (1024, 80), (256, 160))
PARALLEL_SP = (2, 4)
PARALLEL_FWD_BH, PARALLEL_BWD_BH = 16, 8
PARALLEL_RESOLUTION = 512
PARALLEL_TIMESTEPS_TO = 2
PARALLEL_LR = 1e-4
# the multi-rank steps, every rank on this card over gloo: name -> (batch,
# (inner axis, size), control, knobs); the controls must fail the gradient
# gate; `knobs`: every fused knob on (PARALLEL_KNOBS), against the unsharded
# knobs-on step. sp 4 puts 2 rows a rank at the 8 x 8 level
PARALLEL_TWO_RANKS = {
    "dp2_b2": (2, ("tp", 1), None, False),
    "dp2_b1": (1, ("tp", 1), None, False),
    "sp2_b1": (1, ("sp", 2), None, False),
    "tp2_b1": (1, ("tp", 2), None, False),
    "sp2_b1_control_kv_local": (1, ("sp", 2), "kv_local", False),
    "sp2_b1_control_halo_zero": (1, ("sp", 2), "halo_zero", False),
    "sp2_b1_knobs": (1, ("sp", 2), None, True),
    "tp2_b1_knobs": (1, ("tp", 2), None, True),
    "sp2_b1_knobs_control_gnconv_edge_unmasked": (1, ("sp", 2), "gnconv_edge_unmasked", True),
    "sp2_b1_knobs_control_gn_stats_local": (1, ("sp", 2), "gn_stats_local", True),
}
PARALLEL_FOUR_RANKS = {"dp2_sp2_b1": (1, ("sp", 2), None, False),
                       "dp2_sp2_b1_knobs": (1, ("sp", 2), None, True),
                       "sp4_b1_knobs": (1, ("sp", 4), None, True)}
PARALLEL_KNOBS = {**FUSED_KNOBS, "LECO_FLASH_PACKED": "1"}
# the knobs-on case's latents: N(0, 1) scaled by 0.1 in the top half and 1.9
# in the bottom half, an image whose halves differ (`parallel_case`)
KNOBS_LATENT_SCALE = (0.1, 1.9)
# bf16 throughout; the sharded step sums in other orders (GroupNorm's
# statistics over sp, the row-parallel partials over tp, the LoRA gradients
# over the ranks), so the loss is held to RTOL_PARALLEL_LOSS of the
# unsharded step's and the gradients to RTOL_GRAD x max|g| (chip_smoke's
# flash gradient limit)
RTOL_PARALLEL_LOSS = 2e-2
PARALLEL_MEMORY_LIMIT_GIB = 60.0


# kernels 4-8 at the shapes the knobs-on meshes hand them (SD1.5 at 512 px),
# each against its plain version with its control (phase kernels_sharded):
# the row windows (B, Cin, h, W, Cout) of h output rows from h + 2 input
# rows: the refused resnet convs at sp 2 (levels 0 and 1, 32 and 16 rows a
# rank; B 2, the references' 3, the target's 1); GroupNorm-SiLU-conv at
# sp 4 (the 8 x 8 level's 2 rows a rank, once with each edge: the first
# and last ranks' windows hold one padding row) and sp 2; the GroupNorm's
# statistics and apply launches at sp 2 (B, C, h, W, eps, silu); GEGLU at
# tp 2 (N 1280 / 2) and sp 2 (M / 2); the packed forward at sp 2 and 4
# (N / sp query rows against the gathered N keys) and tp 2 (C / 2, 4 heads)
SHARDED_CONV_SHAPES = [(2, 320, 32, 64, 320), (2, 640, 16, 32, 640), (3, 320, 32, 64, 320),
                       (1, 960, 32, 64, 320)]
SHARDED_GNCONV_SHAPES = [(2, 1280, 2, 8, 1280, True, True), (2, 1280, 2, 8, 1280, False, True),
                         (2, 1280, 2, 8, 1280, True, False), (2, 2560, 2, 8, 1280, True, True),
                         (2, 1280, 8, 16, 1280, False, True), (2, 1280, 4, 8, 1280, True, False)]
SHARDED_GN_SHAPES = [(2, 320, 32, 64, 1e-6, False), (2, 320, 32, 64, 1e-5, True),
                     (2, 640, 16, 32, 1e-6, False), (2, 1280, 2, 8, 1e-6, False),
                     (3, 320, 32, 64, 1e-6, False)]
SHARDED_GEGLU_SHAPES = [(8192, 320, 640, 0), (4096, 320, 640, 4), (2048, 640, 1280, 0),
                        (4096, 320, 1280, 0)]
SHARDED_PACKED_SHAPES = [(2, 2048, 4096, 320, 8), (2, 4096, 4096, 160, 4),
                         (2, 1024, 4096, 320, 8), (3, 2048, 4096, 320, 8)]
# label -> the shape where it is timed: the four new entries of kernels 5-7
# (each its own row of the kernels line) and kernels 4 and 8 on their shares
SHARDED_TIMED = {
    "conv3x3_rows": (2, 320, 32, 64, 320),
    "gnconv3x3_rows": (2, 1280, 2, 8, 1280, True, True),
    "group_norm_stats": (2, 320, 32, 64),
    "group_norm_apply": (2, 320, 32, 64, 1e-6, False),
    "geglu_tp2": (8192, 320, 640, 0),
    "attn_fwd_packed_sp2": (2, 2048, 4096, 320, 8),
    "attn_fwd_packed_tp2": (2, 4096, 4096, 160, 4),
}
SHARDED_KERNEL = {"geglu_tp2": "geglu", "attn_fwd_packed_sp2": PACKED,
                  "attn_fwd_packed_tp2": PACKED}
# the entries spatial parallelism adds -> (source, the TPU kernel it replaces)
SHARDED_ENTRIES = {
    "conv3x3_rows": KERNELS["conv3x3"],
    "gnconv3x3_rows": KERNELS["gnconv3x3"],
    "group_norm_stats": KERNELS["group_norm"],
    "group_norm_apply": KERNELS["group_norm"],
}


def sharded_fused_checks(device) -> dict:
    """Kernels 4-8 at the shapes of SHARDED_*_SHAPES, each against its plain
    version (RTOL_FUSED x max|ref|; the packed forward under the O limit;
    the statistics, fp32, at 1e-5 x max|ref|) beside a control that must
    fail it (`testing.*_control`); the SHARDED_TIMED shapes timed beside the
    plain version and the library's call where one computes the same
    function (F.conv2d on the window, SDPA), with the roofline bound ->
    {"worst_abs_err", "timed", "shapes_checked"}."""
    import torch
    import torch.nn.functional as F

    from leco_tpu_torch import testing
    from leco_tpu_torch.kernels import roofline
    from leco_tpu_torch.ops import conv, geglu, gn_conv
    from leco_tpu_torch.ops import flash_attention as fa
    from leco_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device)
    gen.manual_seed(13)

    def bf16(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(
            torch.bfloat16)

    def fp32(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    worst = {label: 0.0 for label in SHARDED_TIMED}
    timed, rows = {}, []

    def held(label, shape, err, limit, control_err, fns, rotate=None):
        """Check an error against its limit and the control against it; time
        `fns` (kernel, plain, library) where `shape` is `label`'s timed one;
        `rotate`: (input, fns_of) for a row bound by bytes."""
        check(err <= limit, f"{label} error {err} > {limit} at {shape}")
        check(control_err > limit, f"the {label} limit {limit} passes its control "
                                   f"({control_err}) at {shape}")
        worst[label] = max(worst.get(label, 0.0), err)
        row = {"kernel": label, "shape": list(shape), "max_abs_err": err, "limit": limit,
               "control_err": control_err}
        if tuple(shape) == SHARDED_TIMED.get(label) and label not in timed:
            bound = roofline.kernel_bound(SHARDED_KERNEL.get(label, label), shape)
            timed[label] = {"shape": list(shape), **row_times(fns, bound, rotate), **bound}
            row.update(timed[label])
        rows.append(row)
        print(json.dumps({"sharded_fused": row}), flush=True)

    def fused_err(got, ref, control):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), "non-finite output")
        limit = RTOL_FUSED * ref.float().abs().max().item()
        return ((got.float() - ref.float()).abs().max().item(), limit,
                (control.float() - ref.float()).abs().max().item())

    for b, cin, h, w, cout in SHARDED_CONV_SHAPES:
        x = bf16((b, cin, h + 2, w))
        wt, bias = bf16((cout, cin, 3, 3), (9 * cin) ** -0.5), fp32((cout,))
        bias16 = bias.to(torch.bfloat16)
        held("conv3x3_rows", (b, cin, h, w, cout),
             *fused_err(conv.conv3x3_rows(x, wt, bias), conv.conv3x3_rows_plain(x, wt, bias),
                        testing.conv3x3_rows_control(x, wt, bias)),
             (lambda: conv.conv3x3_rows(x, wt, bias), lambda: conv.conv3x3_rows_plain(x, wt, bias),
              lambda: F.conv2d(x, wt, bias16, padding=(0, 1))))
    for b, cin, h, w, cout, top, bottom in SHARDED_GNCONV_SHAPES:
        x = bf16((b, cin, h + 2, w))
        if not top:
            x[:, :, 0] = 0
        if not bottom:
            x[:, :, -1] = 0
        a, s = fp32((b, cin), 0.1, 1.0), fp32((b, cin), 0.5, 1.0)
        wt, bias = bf16((cout, cin, 3, 3), (9 * cin) ** -0.5), fp32((cout,))
        args = (x, a, s, wt, bias, True, top, bottom)
        held("gnconv3x3_rows", (b, cin, h, w, cout, top, bottom),
             *fused_err(gn_conv.gnconv3x3_rows(*args), gn_conv.gnconv3x3_rows_plain(*args),
                        testing.gnconv3x3_rows_control(*args)),
             (lambda: gn_conv.gnconv3x3_rows(*args), lambda: gn_conv.gnconv3x3_rows_plain(*args),
              None))
    for b, c, h, w, eps, silu in SHARDED_GN_SHAPES:
        x = bf16((b, c, h, w), 3.0, 1.0)
        scale, bias = fp32((c,), 0.1, 1.0), fp32((c,), 0.1)
        sums = gn.group_norm_stats(x, 32)
        ref = gn.group_norm_stats_plain(x, 32)
        torch.cuda.synchronize()
        limit = 1e-5 * ref.abs().max().item()

        def stats_fns(t):
            return (lambda: gn.group_norm_stats(t, 32), lambda: gn.group_norm_stats_plain(t, 32),
                    None)

        held("group_norm_stats", (b, c, h, w), (sums - ref).abs().max().item(), limit,
             (testing.group_norm_stats_control(x, 32) - ref).abs().max().item(), stats_fns(x),
             rotate=(x, stats_fns))
        # the sums of two ranks' rows, as the sp reduction leaves them
        sums = 2 * ref
        count = c // 32 * 2 * h * w

        def apply_fns(t, eps=eps, silu=silu, scale=scale, bias=bias, sums=sums, count=count):
            return (lambda: gn.group_norm_apply(t, scale, bias, sums, count, eps, silu),
                    lambda: gn.group_norm_apply_plain(t, scale, bias, sums, count, eps, silu),
                    None)

        held("group_norm_apply", (b, c, h, w, eps, silu),
             *fused_err(gn.group_norm_apply(x, scale, bias, sums, count, eps, silu),
                        gn.group_norm_apply_plain(x, scale, bias, sums, count, eps, silu),
                        testing.group_norm_apply_control(x, scale, bias, sums, count, eps,
                                                         silu)),
             apply_fns(x), rotate=(x, apply_fns))
    for m, k, n, r in SHARDED_GEGLU_SHAPES:
        x, wt, bias = bf16((m, k)), bf16((2 * n, k), k**-0.5), fp32((2 * n,))
        xd, up = (bf16((m, r)), bf16((2 * n, r), 0.1)) if r else (None, None)
        args = (x, wt, bias, xd, up)
        held("geglu_tp2" if n == 640 else "geglu_sp2", (m, k, n, r),
             *fused_err(geglu.geglu_gemm(*args), geglu.geglu_gemm_plain(*args),
                        testing.geglu_control(*args)),
             (lambda: geglu.geglu_gemm(*args), lambda: geglu.geglu_gemm_plain(*args), None))
    for b, nq, nk, c, heads in SHARDED_PACKED_SHAPES:
        q = bf16((b, nq, c))
        kk, v = bf16((b, nk, c)), bf16((b, nk, c))
        scale = (c // heads) ** -0.5
        shape = (b, nq, nk, c, heads)
        o = fa.attn_fwd_packed(q, kk, v, heads, scale)
        torch.cuda.synchronize()
        o_check = check_o(o, fa.attn_fwd_packed_plain(q, kk, v, heads, scale),
                          fa.attn_fwd_packed_plain(q, kk[:, :-DROPPED_KEYS],
                                                   v[:, :-DROPPED_KEYS], heads, scale), shape)
        q4, k4, v4 = (t.view(b, t.shape[1], heads, c // heads).transpose(1, 2)
                      for t in (q, kk, v))
        label = "attn_fwd_packed_tp2" if nq == nk else f"attn_fwd_packed_sp{nk // nq}"
        held(label, shape, o_check["o"], o_check["o_limit"], o_check["o_control"],
             (lambda: fa.attn_fwd_packed(q, kk, v, heads, scale),
              lambda: fa.attn_fwd_packed_plain(q, kk, v, heads, scale),
              lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)))
        del q, kk, v, o
        torch.cuda.empty_cache()
    check(set(timed) == set(SHARDED_TIMED), f"sharded timed {sorted(timed)}")
    return {"worst_abs_err": worst, "timed": timed, "shapes_checked": len(rows)}


def sharded_kernel_checks(device) -> dict:
    """Kernels 1-3 at the shapes spatial parallelism hands them, each
    against its plain version under the limits of phase kernels with their
    controls; the level-0 shapes timed beside the plain version and SDPA
    (one SDPA backward beside each of dq and dkv) -> {"shapes": [...],
    "worst_abs_err": {...}, "timed": {sp: {kernel: times}}}."""
    import torch
    import torch.nn.functional as F

    from leco_tpu_torch.kernels import roofline
    from leco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device)
    gen.manual_seed(12)
    warm_up_clocks(device)
    worst = {name: 0.0 for name in FLASH}
    timed, shapes = {}, []
    for sp in PARALLEL_SP:
        for n, d in PARALLEL_LEVELS:
            def rand(bh, rows):
                return torch.randn((bh, rows, d), generator=gen, device=device).to(torch.bfloat16)

            local, scale = n // sp, d**-0.5
            # forward: this rank's query rows against the gathered K/V
            q, k, v = rand(PARALLEL_FWD_BH, local), rand(PARALLEL_FWD_BH, n), rand(PARALLEL_FWD_BH, n)
            o, lse = fa.attn_fwd(q, k, v, scale)
            o_ref, lse_ref = fa.attn_fwd_plain(q, k, v, scale)
            o_dropped, _ = fa.attn_fwd_plain(q, k[:, :-DROPPED_KEYS], v[:, :-DROPPED_KEYS], scale)
            fwd_shape = (PARALLEL_FWD_BH, local, n, d)
            o_check = check_o(o, o_ref, o_dropped, fwd_shape)
            lse_err = (lse - lse_ref).abs().max().item()
            check(lse_err <= ATOL_LSE, f"LSE error {lse_err} > {ATOL_LSE} at {fwd_shape}")
            # dq: the local rows against the gathered K/V; dk/dv: the local K/V
            # rows against the gathered Q, dO, lse and delta
            bh = PARALLEL_BWD_BH
            ql, kf, vf, gl = rand(bh, local), rand(bh, n), rand(bh, n), rand(bh, local)
            ol, lse_l = fa.attn_fwd_plain(ql, kf, vf, scale)
            delta_l = (gl.float() * ol.float()).sum(-1)
            qf, kl, vl, gf = rand(bh, n), rand(bh, local), rand(bh, local), rand(bh, n)
            of, lse_f = fa.attn_fwd_plain(qf, kl, vl, scale)
            delta_f = (gf.float() * of.float()).sum(-1)
            got = {"dq": fa.attn_bwd_dq(ql, kf, vf, gl, lse_l, delta_l, scale)}
            got["dk"], got["dv"] = fa.attn_bwd_dkv(qf, kl, vl, gf, lse_f, delta_f, scale)
            ref = {"dq": fa.attn_bwd_dq_plain(ql, kf, vf, gl, lse_l, delta_l, scale)}
            ref["dk"], ref["dv"] = fa.attn_bwd_dkv_plain(qf, kl, vl, gf, lse_f, delta_f, scale)
            kept = slice(0, n - DROPPED_QUERIES)
            control = {"dq": fa.attn_bwd_dq_plain(ql, kf[:, :-DROPPED_KEYS], vf[:, :-DROPPED_KEYS],
                                                  gl, lse_l, delta_l, scale)}
            control["dk"], control["dv"] = fa.attn_bwd_dkv_plain(
                qf[:, kept], kl, vl, gf[:, kept], lse_f[:, kept], delta_f[:, kept], scale)
            torch.cuda.synchronize()
            dq_shape, dkv_shape = (bh, local, n, d), (bh, n, local, d)
            grads = check_grads(got, ref, control, (dq_shape, dkv_shape))
            worst["attn_fwd"] = max(worst["attn_fwd"], o_check["o"], lse_err)
            worst["attn_bwd_dq"] = max(worst["attn_bwd_dq"], grads["err"]["dq"])
            worst["attn_bwd_dkv"] = max(worst["attn_bwd_dkv"], grads["err"]["dk"],
                                        grads["err"]["dv"])
            row = {"sp": sp, "fwd": fwd_shape, "dq": dq_shape, "dkv": dkv_shape,
                   "max_abs_err": {"o": o_check["o"], "lse": lse_err, **grads["err"]},
                   "o_limit": o_check["o_limit"], "o_control": o_check["o_control"],
                   "grad_limit": grads["grad_limit"], "grad_control": grads["grad_control"]}
            if n == PARALLEL_LEVELS[0][0]:
                def sdpa_backward(qq, kk, vv, gg):
                    qg, kg, vg = (t[None].detach().requires_grad_() for t in (qq, kk, vv))
                    out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
                    return lambda: torch.autograd.grad(out, (qg, kg, vg), gg[None],
                                                       retain_graph=True)

                fns = {
                    "attn_fwd": (lambda: fa.attn_fwd(q, k, v, scale),
                                 lambda: fa.attn_fwd_plain(q, k, v, scale),
                                 lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                        scale=scale)),
                    "attn_bwd_dq": (
                        lambda: fa.attn_bwd_dq(ql, kf, vf, gl, lse_l, delta_l, scale),
                        lambda: fa.attn_bwd_dq_plain(ql, kf, vf, gl, lse_l, delta_l, scale),
                        sdpa_backward(ql, kf, vf, gl)),
                    "attn_bwd_dkv": (
                        lambda: fa.attn_bwd_dkv(qf, kl, vl, gf, lse_f, delta_f, scale),
                        lambda: fa.attn_bwd_dkv_plain(qf, kl, vl, gf, lse_f, delta_f, scale),
                        sdpa_backward(qf, kl, vl, gf)),
                }
                kernel_shapes = {"attn_fwd": fwd_shape, "attn_bwd_dq": dq_shape,
                                 "attn_bwd_dkv": dkv_shape}
                timed[sp] = {name: {"shape": kernel_shapes[name], **kernel_times(*f),
                                    **roofline.kernel_bound(name, kernel_shapes[name])}
                             for name, f in fns.items()}
                row["timed"] = timed[sp]
                del fns
            print(json.dumps({"sharded_kernels": row}), flush=True)
            shapes.append(row)
            del q, k, v, o, o_ref, o_dropped, got, ref, control
            torch.cuda.empty_cache()
    return {"shapes": shapes, "worst_abs_err": worst, "timed": timed,
            "fused": sharded_fused_checks(device)}


def parallel_case(batch: int, knobs: bool = False) -> dict:
    """The multi-rank step's case: the full-width SD1.5 random bundle (bf16,
    seed 0, its lora_up drawn), the van-gogh erase pack and seeded latents
    at PARALLEL_RESOLUTION, on the CPU (each rank moves it to the card).
    The knobs-on meshes' latents are scaled by KNOBS_LATENT_SCALE in the
    top and the bottom half: a random bundle on N(0, 1) latents makes every
    row of every feature alike, so that a rank's GroupNorm statistics match
    the image's to sampling noise and the image's edge rows look like any
    other, and the two knob controls would stay under the gradient limit
    (0.87x and 0.90x of it on N(0, 1) latents, PERF.md section 6)."""
    import torch

    from leco_tpu_torch.models.unet import sd15_config
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import fake_encode_fn
    from leco_tpu_torch.train import trainer

    settings = PromptSettings.from_dict({"target": "van gogh", "positive": "van gogh",
                                         "resolution": PARALLEL_RESOLUTION,
                                         "batch_size": batch})
    (pair,) = trainer.encode_prompt_pairs([settings], fake_encode_fn(768, "cpu"))
    gen = torch.Generator().manual_seed(100 + batch)
    side = PARALLEL_RESOLUTION // 8
    latents = torch.randn((batch, 4, side, side), generator=gen)
    if knobs:
        top, bottom = KNOBS_LATENT_SCALE
        latents[:, :, : side // 2] *= top
        latents[:, :, side // 2:] *= bottom
    return {"config": sd15_config(), "seed": 0, "dtype": torch.bfloat16,
            "res": PARALLEL_RESOLUTION, "max_steps": 50, "timesteps_to": PARALLEL_TIMESTEPS_TO,
            "guidance_scale": pair.guidance_scale, "erase_sign": pair.erase_sign,
            "pack": trainer.build_pack(pair),
            "latents": latents}


def parallel_gate(got: dict, ref: dict) -> dict:
    """The LoRA gradients of a sharded step against the unsharded one's ->
    error, limit (RTOL_GRAD x max|g| over the tree)."""
    size = max(v.abs().max().item() for v in ref.values())
    err = max((got[k] - v).abs().max().item() for k, v in ref.items())
    return {"grad_err": err, "grad_limit": RTOL_GRAD * size}


def parallel_nccl_cli(ckpt: Path, out_dir: Path) -> dict:
    """The default recipe through the CLI's `main()` with a launcher's
    environment at world size 1: torch.distributed starts on NCCL."""
    import socket

    import torch
    import torch.distributed as dist

    from leco_tpu_torch.utils import yaml_subset

    config = yaml_subset.load(REPO / "examples" / "config.yaml")
    config["prompts_file"] = str(REPO / "examples" / "prompts.yaml")
    config["pretrained_model"]["name_or_path"] = str(ckpt)
    config["train"]["iterations"] = 2
    config["save"]["path"] = str(out_dir / "nccl")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": port}
    try:
        with environ(env):
            run = run_cli(config, out_dir / "config_nccl.yaml")
            backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    losses = run["result"]["losses"]
    check(backend == "nccl", f"the CLI started {backend}, not NCCL")
    check(len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)).tolist()),
          f"NCCL CLI losses {losses}")
    check((out_dir / "nccl" / "van_gogh_last.safetensors").exists(), "NCCL CLI save")
    return {"backend": backend, "losses": losses, "launches": run["launches"],
            "seconds": run["seconds"]}


def phase_parallel(device, ckpt: Path, out_dir: Path) -> dict:
    """One step of each mesh of
    PARALLEL_TWO_RANKS and PARALLEL_FOUR_RANKS, every rank on this card over
    gloo (`leco_tpu_torch.parallel.testing`), against the unsharded step on
    the same weights and latents, knobs off or on as the mesh's step: the
    loss, the LoRA gradients (the four controls must fail), bitwise the same
    LoRA on every rank, each rank's launches of the eight kernels the
    unsharded step's (a row window counts as its kernel, a split GroupNorm
    once: its statistics launches as many as its apply launches); the CLI
    through NCCL at world size 1. No time of the ranks that share the card
    is a parallel speed."""
    import torch

    from leco_tpu_torch.parallel import testing as ptesting

    cases = {"1": parallel_case(1), "2": parallel_case(2), "1_knobs": parallel_case(1, True)}
    refs = {}
    for key, case in cases.items():
        knobs = key.endswith("_knobs")
        unet, spec = ptesting.build_unet(case, device)
        torch.cuda.reset_peak_memory_stats()
        # cuDNN deterministic, as the ranks run
        with torch.backends.cudnn.flags(enabled=True, deterministic=True), \
                environ(PARALLEL_KNOBS if knobs else {}):
            refs[key] = ptesting.step_once(unet, spec, case, device, PARALLEL_LR)
        refs[key]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        refs[key]["kernel_launches"] = ptesting.per_kernel(refs[key]["calls"])
        del unet
        torch.cuda.empty_cache()
    for key, ref in refs.items():  # the unsharded step runs every kernel of the path
        on_path = ((PACKED, "conv3x3", "gnconv3x3", "group_norm", "geglu")
                   if key == "1_knobs" else FLASH)
        check(all(ref["kernel_launches"][name] > 0 for name in on_path),
              f"the unsharded {key} step launched {ref['calls']}")
    print(json.dumps({"parallel_reference": {k: {"loss": r["loss"], "calls": r["calls"],
                                                 "peak_mem_gb": r["peak_mem_gb"]}
                                             for k, r in refs.items()}}), flush=True)

    results, worlds = {}, {}
    for world, steps in ((2, PARALLEL_TWO_RANKS), (4, PARALLEL_FOUR_RANKS)):
        job = {"kind": "steps", "device": str(device), "lr": PARALLEL_LR, "threads": 2,
               "cases": cases,
               "steps": {name: {"case": f"{b}_knobs" if knobs else str(b), "mesh": mesh,
                                "control": control,
                                "knobs": PARALLEL_KNOBS if knobs else {}}
                         for name, (b, mesh, control, knobs) in steps.items()}}
        t0 = time.perf_counter()
        ranks = ptesting.spawn(job, world, out_dir / f"parallel_world{world}")
        worlds[world] = {"seconds": time.perf_counter() - t0,
                         "foreign_modules": [r["foreign_modules"] for r in ranks],
                         "peak_mem_gb_sum": sum(max(r[s].get("peak_mem_gb", 0.0) for s in steps)
                                                for r in ranks)}
        check(all(not m for m in worlds[world]["foreign_modules"]),
              f"rank processes imported {worlds[world]['foreign_modules']}")
        for name, (b, mesh, control, knobs) in steps.items():
            ref = refs[f"{b}_knobs" if knobs else str(b)]
            per_rank = []
            for rank, r in enumerate(ranks):
                res = r[name]
                gate = parallel_gate(res["grads"], ref["grads"])
                loss_err = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
                launches_ = {k: v for k, v in res["calls"].items() if k.startswith("launches_")}
                kernel_launches = ptesting.per_kernel(res["calls"])
                want = ref["kernel_launches"]
                if control is None:
                    check(gate["grad_err"] <= gate["grad_limit"],
                          f"{name} rank {rank}: LoRA grads differ by {gate['grad_err']} > "
                          f"{gate['grad_limit']}")
                    check(loss_err <= RTOL_PARALLEL_LOSS,
                          f"{name} rank {rank}: loss {res['loss']} vs {ref['loss']}")
                    check(kernel_launches == want and launches_["launches_group_norm_stats"]
                          == launches_["launches_group_norm_apply"],
                          f"{name} rank {rank}: launches {launches_} != {want}")
                    if knobs and mesh[0] == "sp":  # every conv and norm on its sp entry
                        check(all(launches_[f"launches_{n}"] > 0 for n in SHARDED_ENTRIES),
                              f"{name} rank {rank}: launches {launches_}")
                else:
                    check(gate["grad_err"] > gate["grad_limit"],
                          f"{name}: the gradient limit {gate['grad_limit']} passes the control "
                          f"({gate['grad_err']})")
                per_rank.append({"loss": res["loss"], "loss_rel_err": loss_err, **gate,
                                 "launches": launches_, "kernel_launches": kernel_launches,
                                 "coords": res["coords"],
                                 "tp_layers": res["tp_layers"],
                                 "peak_mem_gb": res.get("peak_mem_gb")})
            bitwise = all(torch.equal(r[name]["lora"][k], ranks[0][name]["lora"][k])
                          for r in ranks[1:] for k in ranks[0][name]["lora"])
            if control is None:
                check(bitwise, f"{name}: the ranks' LoRA differ after the step")
            results[name] = {"world": world, "mesh": mesh, "control": control, "knobs": knobs,
                             "bitwise_equal_lora": bitwise, "ranks": per_rank}
            print(json.dumps({"parallel_step": {name: results[name]}}), flush=True)
        del ranks
    check(worlds[4]["peak_mem_gb_sum"] < PARALLEL_MEMORY_LIMIT_GIB,
          f"the 4-rank run peaks at {worlds[4]['peak_mem_gb_sum']} GiB")
    print(f"parallel: 4-rank peak (sum of the ranks' peaks) "
          f"{worlds[4]['peak_mem_gb_sum']:.2f} GiB",
          flush=True)
    nccl = parallel_nccl_cli(ckpt, out_dir)
    return {"references": {k: {"loss": r["loss"], "calls": r["calls"]}
                           for k, r in refs.items()},
            "steps": results, "worlds": worlds, "nccl_cli": nccl}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU")
    sys.path.insert(0, str(REPO))
    from leco_tpu_torch.kernels import roofline
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.testing import make_sd15_bundle

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase("device", dev)
    phase("build", phase_build())
    kernels = phase_kernels(device)
    phase("kernels", kernels)
    # the parallel path's shapes of kernels 1-3 (phase parallel runs the
    # path itself, late, on phase cli's checkpoint)
    sharded = sharded_kernel_checks(device)
    phase("kernels_sharded", sharded)
    fused_kernels = phase_fused_kernels(device)
    phase("fused_kernels", fused_kernels)

    t0 = time.perf_counter()
    bundle = make_sd15_bundle(dtype=torch.bfloat16, seed=0, device=device)
    check(bundle.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.backend
          == "flash", "the CUDA bundle does not default to the kernels")
    torch.cuda.synchronize()
    print(f"bundle built in {time.perf_counter() - t0:.1f} s", flush=True)
    phase("unet", phase_unet(bundle, device))
    phase("unet_fused", phase_unet_fused(bundle, device))
    phase("profile", phase_profile(bundle, device))
    with tempfile.TemporaryDirectory() as tmp:
        train_result = phase_train(bundle, Path(tmp))
    phase("train", train_result)
    with tempfile.TemporaryDirectory() as tmp:
        train_fused = phase_train(bundle, Path(tmp), fused=True)
    phase("train_fused", train_fused)
    phase("jax_knobs", phase_jax_knobs(bundle, device))
    del bundle
    torch.cuda.empty_cache()
    # c3lier: LoRA on every resnet and upsampler conv, so the resnet convs
    # take conv3x3 (never gnconv3x3) and the upsamplers do on the target pass
    bundle = make_sd15_bundle(dtype=torch.bfloat16, seed=0, device=device,
                              spec=LoRASpec(rank=4, alpha=1.0, network_type="c3lier"))
    with tempfile.TemporaryDirectory() as tmp:
        train_c3lier = phase_train(bundle, Path(tmp), fused=True)
    phase("train_fused_c3lier", train_c3lier)
    del bundle
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase("bench", phase_bench(Path(tmp)))
    phase("scripts", phase_scripts())
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase_cli(device, Path(tmp))
        phase("cli", cli)
        phase("recipes", phase_recipes(device, Path(tmp) / SD21_CHECKPOINT, Path(tmp)))
        phase("infer", phase_infer(device, Path(tmp) / SD21_CHECKPOINT, Path(tmp)))
        parallel = phase_parallel(device, Path(tmp) / SD21_CHECKPOINT, Path(tmp))
        phase("parallel", parallel)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase("xl", phase_xl(device, Path(tmp)))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase("ti", phase_ti(device, Path(tmp)))

    # each kernel's launches come from the run of the path it is on: the
    # flash kernels from the default path, the fused ones from the knobs-on
    # lierla path, the packed one from the CLI's LECO_FLASH_PACKED=1 run
    # (each driven with the counts at 0 just before it); every kernel's also
    # from each parallel mesh's step, rank 0's; the entries that spatial
    # parallelism adds from the knobs-on sp 2 step, rank 0's
    parallel_launches = {
        name: {mesh: result["ranks"][0]["kernel_launches"][name]
               for mesh, result in parallel["steps"].items() if result["control"] is None}
        for name in KERNELS}
    sharded_launches = parallel["steps"]["sp2_b1_knobs"]["ranks"][0]["launches"]
    fused_sharded = sharded["fused"]
    sharded_rows = {PACKED: ("attn_fwd_packed_sp2", "attn_fwd_packed_tp2"),
                    "geglu": ("geglu_tp2",)}
    measured = {**{n: (kernels, train_result) for n in FLASH},
                PACKED: (kernels, cli["packed"]),
                **{n: (fused_kernels, train_fused) for n in FUSED}}
    timed_shapes = {**TIMED_SHAPE, PACKED: PACKED_TIMED, **FUSED_TIMED}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": measured[name][1]["launches"][name],
            "max_abs_err": measured[name][0]["worst_abs_err"][name],
            "ms": measured[name][0]["timed_ms"][name]["ms"],
            "plain_ms": measured[name][0]["timed_ms"][name]["plain_ms"],
            # the least time for the same work at the timed shape
            **roofline.kernel_bound(name, timed_shapes[name]),
            # one PyTorch call that computes the same function, or null
            "library_ms": measured[name][0]["timed_ms"][name]["library_ms"],
            # the device's own time per call (torch.profiler), the same three
            **{key: measured[name][0]["timed_ms"][name][key]
               for key in ("device_ms", "plain_device_ms", "library_device_ms")},
            "parallel_launches": parallel_launches[name],
            **({"sharded": {label: fused_sharded["timed"][label]
                            for label in sharded_rows[name]}} if name in sharded_rows else {}),
        }
        for name, (source, replaces) in KERNELS.items()
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sharded_launches[f"launches_{name}"],
            "max_abs_err": fused_sharded["worst_abs_err"][name],
            **{key: fused_sharded["timed"][name][key]
               for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                           "plain_device_ms", "library_device_ms")},
            "shape": fused_sharded["timed"][name]["shape"],
        }
        for name, (source, replaces) in SHARDED_ENTRIES.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
