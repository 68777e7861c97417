"""UNet micro-profile on the card: forward and forward+backward time per
call and MFU, for the flash kernels and plain attention, with
`checkpoint_unet` off and on.

    python -m leco_tpu_torch.scripts.profile_unet [--res 512] [--batch 2] \
        [--iters 20] [--device cuda|cpu]

Counterpart of `scripts/profile_unet.py`. The forward runs with the LoRA
folded into the base weights (the JAX script's `merge_params`), without
gradients; the forward+backward is the train step's target pass: the LoRA
on and the gradient of its parameters alone, the base weights frozen (the
JAX script differentiates every weight of the merged tree, which no train
step does). `--device` defaults to cuda and raises without a GPU.

MFU is taken from the FLOPs of the port's own UNet, counted by
`torch.utils.flop_counter.FlopCounterMode` on the `meta` device with plain
attention (`counted_unet_flops`): the matrix products and convolutions the
forward (or backward) must do, whatever implements them, the kernels, SDPA
or the plain path. `unet_flops`, the JAX script's analytic estimate ("good
to ~5%"), is printed beside it: it counts 3 convs for every resnet, 5
transformers on levels 0-2 and an upsampler as a plain 3x3 conv, and reads
15% low at 512 px (the counted SD1.5 forward is 1.173x it).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import NamedTuple

import torch

FLOP_DEVICE = "meta"
SD_TIMESTEP = 500.0
TEXT_TOKENS = 77


def unet_flops(res: int, batch: int) -> float:
    """Rough analytic FLOPs for one SD1.5 UNet forward (batch item @res).
    Counted from conv/matmul dims; good to ~5%. (The JAX script's estimate,
    kept as it is so that the two can be compared; `counted_unet_flops` is
    the count the MFU uses.)"""
    h = res // 8
    # per level: (channels, spatial, n_resnet_convs, attn tokens)
    total = 0.0
    ch = [320, 640, 1280, 1280]
    sp = [h, h // 2, h // 4, h // 8]
    # conv_in/out
    total += 2 * (h * h) * 9 * 4 * 320 * 2
    for i in range(4):
        c, s = ch[i], sp[i]
        n_res = 2 * 3 + 3 * 3  # down 2 + up 3 resnets, ~3 convs each
        total += n_res * 2 * (s * s) * 9 * c * c
        if i < 3:
            n_tf = 5  # 2 down + 3 up transformers
            seq = s * s
            # qkv+out (4 c^2) + ff (8 c^2) per token + attn (2 seq^2 c)
            total += n_tf * (2 * seq * 12 * c * c + 2 * 2 * seq * seq * c)
    # mid block
    c, s = 1280, sp[3]
    total += 2 * 2 * (s * s) * 9 * c * c * 3
    total += 2 * (s * s) * 12 * c * c + 2 * 2 * (s * s) ** 2 * c
    return total * batch


def meta_unet(config, lora=None):
    """The port's UNet on the meta device (bf16, plain attention, weights
    frozen), with `lora`'s LoRA branch where it is a LoRASpec."""
    from leco_tpu_torch.lora import apply_lora_spec
    from leco_tpu_torch.models.unet import UNet2DConditionModel

    with torch.device(FLOP_DEVICE):
        unet = UNet2DConditionModel(config, dtype=torch.bfloat16, attn_backend="xla")
    unet.requires_grad_(False)
    if lora is not None:
        apply_lora_spec(unet, lora, torch.Generator())  # the LoRA parameters train
    return unet


def meta_inputs(config, res: int, batch: int) -> tuple:
    """(latents, timestep, text embeddings, added conditions or None) of
    one UNet call on the meta device."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=FLOP_DEVICE)

    added = None
    if config.addition_embed_type == "text_time":
        pooled = (config.projection_class_embeddings_input_dim
                  - 6 * config.addition_time_embed_dim)
        added = {"text_embeds": zeros(batch, pooled), "time_ids": zeros(batch, 6)}
    return (zeros(batch, config.in_channels, res // 8, res // 8), SD_TIMESTEP,
            zeros(batch, TEXT_TOKENS, config.cross_attention_dim), added)


def _flops(fn) -> tuple[int, object]:
    """(FLOPs counted while `fn()` runs, its result)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        result = fn()
    return counter.get_total_flops(), result


def counted_unet_flops(config, res: int, batch: int, backward: bool = False,
                       lora=None) -> int:
    """FLOPs (matrix products and convolutions) of one UNet forward at
    `res` px and `batch`, counted over the port's UNet on the meta device
    with plain attention; with `backward`, those of its backward alone: the
    gradient of the LoRA parameters where `lora` (a LoRASpec) is given, as
    the train step's target pass takes it (the latents need none), else the
    gradient of the input. `lora` puts the LoRA branch, on, in the forward."""
    unet = meta_unet(config, lora)
    x, t, ctx, added = meta_inputs(config, res, batch)
    if not backward:
        with torch.no_grad():
            return _flops(lambda: unet(x, t, ctx, added))[0]
    if lora is None:
        x.requires_grad_(True)
    out = unet(x, t, ctx, added)
    return _flops(lambda: out.float().sum().backward())[0]


class StepFlopParts(NamedTuple):
    """Counted FLOPs of the parts of one train step at batch B."""

    forward: int  # one forward at B, the LoRA off (or folded: the same products)
    target_forward: int  # one forward at B, the LoRA on
    target_backward: int  # its backward, to the LoRA parameters
    lora_fold: int  # folding the LoRA into the base weights


@functools.lru_cache(maxsize=8)
def step_flop_parts(config, res: int, batch: int, lora) -> StepFlopParts:
    """`counted_unet_flops`' count of each part of one train step at batch
    B = `batch`, on one meta UNet with `lora`'s branch. Every counted
    operation's FLOPs are linear in the batch, so a forward at 2B or 3B is
    twice or three times the one at B."""
    from leco_tpu_torch.lora import folded_lora, lora_mode

    unet = meta_unet(config, lora)
    x, t, ctx, added = meta_inputs(config, res, batch)

    def fold():
        with folded_lora(unet):
            pass

    with torch.no_grad():
        with lora_mode(unet, "off"):
            forward = _flops(lambda: unet(x, t, ctx, added))[0]
        lora_fold = _flops(fold)[0]
    target_forward, out = _flops(lambda: unet(x, t, ctx, added))
    target_backward = _flops(lambda: out.float().sum().backward())[0]
    return StepFlopParts(forward, target_forward, target_backward, lora_fold)


def step_flops(config, res: int, batch: int, timesteps_to: int, lora=None) -> dict:
    """The counted FLOPs of one train step (`trainer.make_train_step`) at
    `timesteps_to` t: t CFG forwards at 2B with the LoRA folded, one
    reference forward at 3B with the LoRA off, and the target forward and
    backward at B with the LoRA on, plus the LoRA's fold; the loss and the
    optimizer's elementwise work are not counted. The rank-r LoRA products
    are in the count: the target pass's LoRA branch, its gradients and the
    fold. `lora_products` and `lora_share` say how much of the count they
    are, from the same step at rank 2r (the LoRA products are linear in r,
    the base weights' are independent of it, where r is not clamped to a
    layer's width: lierla's). `lora` defaults to the bench's rank-4
    lierla."""
    from leco_tpu_torch.lora import LoRASpec

    lora = lora or LoRASpec(rank=4, alpha=1.0)
    parts = step_flop_parts(config, res, batch, lora)
    out = {
        "inner_forwards": 2 * timesteps_to * parts.forward,
        "reference_forward": 3 * parts.forward,
        "target_forward": parts.target_forward,
        "target_backward": parts.target_backward,
        "lora_fold": parts.lora_fold,
    }
    out["total"] = sum(out.values())
    doubled = step_flop_parts(config, res, batch, dataclasses.replace(lora, rank=2 * lora.rank))
    out["lora_products"] = sum(doubled) - sum(parts)
    out["lora_share"] = out["lora_products"] / out["total"]
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_unet(bundle, res: int, batch: int, iters: int) -> dict:
    """Seconds per call of the bundle's UNet: the forward with the LoRA
    folded (no gradient), `iters` calls, and the target pass (forward with
    the LoRA on, backward to the LoRA parameters), max(1, iters // 2)
    calls; each after one warm-up call, the clock stopped after a
    synchronize."""
    from leco_tpu_torch.lora import folded_lora

    unet, device = bundle.unet, bundle.device
    gen = torch.Generator(device)
    gen.manual_seed(0)
    cfg = unet.cfg
    x = torch.randn((batch, cfg.in_channels, res // 8, res // 8), generator=gen,
                    device=device).to(torch.bfloat16)
    ctx = torch.randn((batch, TEXT_TOKENS, cfg.cross_attention_dim), generator=gen,
                      device=device).to(torch.bfloat16)
    lora = list(bundle.lora_params.values())

    def timed(fn, n: int) -> float:
        fn()
        _synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _synchronize(device)
        return (time.perf_counter() - t0) / n

    def target():
        for p in lora:
            p.grad = None
        unet(x, SD_TIMESTEP, ctx).float().pow(2).mean().backward()

    with torch.no_grad(), folded_lora(unet):
        fwd_s = timed(lambda: unet(x, SD_TIMESTEP, ctx), iters)
    fwd_bwd_s = timed(target, max(1, iters // 2))
    return {"fwd_s": fwd_s, "fwd_bwd_s": fwd_bwd_s}


def main(argv=None) -> dict:
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.models.unet import sd15_config
    from leco_tpu_torch.testing import make_sd15_bundle
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device to time on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    res, batch = args.res, args.batch
    spec = LoRASpec(rank=4, alpha=1.0)
    config = sd15_config()
    fwd_flops = counted_unet_flops(config, res, batch)
    target_flops = (counted_unet_flops(config, res, batch, lora=spec)
                    + counted_unet_flops(config, res, batch, backward=True, lora=spec))
    analytic = unet_flops(res, batch)
    print(f"counted SD1.5 fwd GFLOPs/img @ {res}px: {fwd_flops / batch / 1e9:.0f} "
          f"(unet_flops {analytic / batch / 1e9:.0f}; counted / unet_flops "
          f"{fwd_flops / analytic:.3f})", flush=True)

    results = {}
    for backend in ("flash", "xla"):
        for remat in (False, True):
            bundle = make_sd15_bundle(spec=spec, attn_backend=backend, device=device)
            bundle.unet.checkpoint_unet = remat
            times = time_unet(bundle, res, batch, args.iters)
            del bundle
            if on_card:
                torch.cuda.empty_cache()
            # MFU is a device number: none for a CPU run
            mfu_fwd = fwd_flops / times["fwd_s"] / BF16_TENSOR_FLOPS if on_card else None
            mfu_bwd = target_flops / times["fwd_bwd_s"] / BF16_TENSOR_FLOPS if on_card else None
            key = f"{backend},remat={remat}"
            results[key] = {"fwd_ms": times["fwd_s"] * 1e3, "fwd_bwd_ms": times["fwd_bwd_s"] * 1e3,
                            "mfu_fwd": mfu_fwd, "mfu_fwd_bwd": mfu_bwd}
            mfu_text = (f"{100 * mfu_fwd:4.1f}% MFU" if on_card else "MFU not measured")
            print(f"{key:18s} fwd {times['fwd_s'] * 1e3:7.2f}ms ({mfu_text})  "
                  f"fwd+bwd {times['fwd_bwd_s'] * 1e3:7.2f}ms", flush=True)
    record = {
        "res": res, "batch": batch, "iters": args.iters,
        "platform": benchkit.platform(device),
        "device": benchkit.device_record() if on_card else None,
        "counted_fwd_flops": fwd_flops, "counted_target_fwd_bwd_flops": target_flops,
        "unet_flops": analytic, "counted_over_unet_flops": fwd_flops / analytic,
        "peak_flops": BF16_TENSOR_FLOPS, "results": results,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
