"""The work of one train step, counted over the benchmark's own reference
UNet, so that the count is the same whatever implements the step.

`torch.utils.flop_counter.FlopCounterMode` counts the matrix products and
convolutions of the reference on the `meta` device. One step at t_to is

    2B x t_to forwards with the LoRA folded (the products of the LoRA off),
    one forward at 3B with the LoRA off,
    the target forward at B with the LoRA on and its backward to the LoRA,
    and the fold of every LoRA into its weight;

every counted product is linear in the batch, so a forward at 2B or 3B is
twice or three times the one at B. The loss and the optimizer's
elementwise work are not counted. The upsamplers count as the published
nearest-2x upsample followed by a 3x3 convolution.
"""

from __future__ import annotations

import functools

import torch

from reference.unet import Attention, UNet, UNetSizes

TEXT_TOKENS = 77


def _inputs(sizes: UNetSizes, res: int, batch: int):
    def zeros(*shape):
        return torch.zeros(shape, device="meta")

    added = None
    if sizes.addition_embed_type == "text_time":
        added = {"text_embeds": zeros(batch, sizes.pooled_dim), "time_ids": zeros(batch, 6)}
    return (zeros(batch, sizes.in_channels, res // 8, res // 8), 500.0,
            zeros(batch, TEXT_TOKENS, sizes.cross_attention_dim), added)


def _meta_unet(sizes: UNetSizes, rank: int, alpha: float) -> UNet:
    with torch.device("meta"):
        unet = UNet(sizes)
        unet.requires_grad_(False)
        unet.add_lora(rank, alpha)
    return unet


def _count(fn) -> tuple[int, object]:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return counter.get_total_flops(), out


@functools.lru_cache(maxsize=8)
def step_parts(sizes: UNetSizes, res: int, batch: int, rank: int, alpha: float) -> dict:
    """Counted FLOPs of the parts of one step at batch B = `batch`."""
    unet = _meta_unet(sizes, rank, alpha)
    x, t, text, added = _inputs(sizes, res, batch)
    with torch.no_grad():
        unet.run.mode = "off"
        forward = _count(lambda: unet(x, t, text, added))[0]
        unet.run.mode = "folded"
        fold = _count(lambda: [m._weight() for m in unet.lora_layers().values()])[0]
    unet.run.mode = "on"
    target_forward, out = _count(lambda: unet(x, t, text, added))
    target_backward = _count(lambda: out.float().sum().backward())[0]
    return {"forward": forward, "target_forward": target_forward,
            "target_backward": target_backward, "fold": fold}


def step_flops(sizes: UNetSizes, res: int, batch: int, rank: int, alpha: float,
               t_to: int) -> int:
    p = step_parts(sizes, res, batch, rank, alpha)
    return ((2 * t_to + 3) * p["forward"] + p["target_forward"] + p["target_backward"]
            + p["fold"])


@functools.lru_cache(maxsize=8)
def attention_calls(sizes: UNetSizes, res: int, batch: int) -> tuple:
    """((BH, Nq, Nk, D), ...) of every attention core of one forward at
    `batch`, in call order."""
    unet = _meta_unet(sizes, 1, 1.0)
    calls = []

    def hook(mod, args, kwargs, output):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("ctx")
        nk = x.shape[1] if ctx is None else ctx.shape[1]
        c = x.shape[2]
        calls.append((x.shape[0] * mod.heads, x.shape[1], nk, c // mod.heads))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in unet.modules() if isinstance(m, Attention)]
    with torch.no_grad():
        unet(*_inputs(sizes, res, batch))
    for h in handles:
        h.remove()
    return tuple(calls)
