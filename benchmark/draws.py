"""Everything a run draws from its `--seed`: the antithetic `timesteps_to`
pairs, the UNet weights, the LoRA's initial factors, the prompt embeddings
and the initial latents. Each has a stream of its own, so that one draw
never shifts another. The program and the reference are handed the same
values.

The timesteps: the recipe draws `timesteps_to` uniformly from [low, high)
every iteration. Here the first of each pair is such a draw and the second
is low + high - 1 - t, so each is still uniform on [low, high) while every
pair costs the same (2 * mean forwards); a window of whole pairs then does
the same work whatever the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = {"t_to": 0, "weights": 1, "lora": 2, "embeds": 3, "latents": 4}
CHUNK = 1 << 27  # elements of one draw: a few large calls, never one a leaf


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for one stream of `seed`."""
    ss = np.random.SeedSequence([seed % 2**63, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device)
    g.manual_seed(sub_seed(seed, stream))
    return g


class TimestepPairs:
    """The run's `timesteps_to`, pair by pair, from one seeded stream."""

    def __init__(self, seed: int, low: int, high: int):
        self.rng = np.random.default_rng(sub_seed(seed, "t_to"))
        self.low, self.high = low, high

    def next_pair(self) -> tuple[int, int]:
        t = int(self.rng.integers(self.low, self.high))
        return t, self.low + self.high - 1 - t


def _is_norm(name: str) -> bool:
    return "norm" in name.rsplit(".", 2)[-2]


def unet_weights(shapes: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """{name: tensor} for every base weight, in name order from one
    stream: a weight (2 or more dims) N(0, 1/fan_in), a bias N(0, 0.02^2),
    a norm's scale 1 + N(0, 0.1^2) and its shift N(0, 0.1^2). Norm
    parameters are float32 (as the program keeps them), every other leaf
    `dtype`."""
    g = generator(seed, "weights", device)
    names = sorted(shapes)
    out = {}
    pending: list = []  # names whose values the next draw covers
    size = 0

    def flush():
        nonlocal size
        if not pending:
            return
        flat = torch.randn(size, generator=g, device=device, dtype=torch.float32)
        offset = 0
        for name in pending:
            shape = shapes[name]
            n = math.prod(shape)
            z = flat[offset:offset + n].view(shape)
            offset += n
            if _is_norm(name):
                v = (1 + 0.1 * z) if name.endswith("weight") else 0.1 * z
                out[name] = v.clone()
            elif len(shape) >= 2:
                out[name] = (z * (1.0 / math.sqrt(math.prod(shape[1:])))).to(dtype)
            else:
                out[name] = (0.02 * z).to(dtype)
        pending.clear()
        size = 0

    for name in names:
        n = math.prod(shapes[name])
        if size and size + n > CHUNK:
            flush()
        pending.append(name)
        size += n
    flush()
    return out


def lora_init(shapes: dict, seed: int, device) -> dict:
    """The LoRA's factors, float32, in one draw: every `lora_down` and every
    `lora_up` uniform on +-1/sqrt(fan_in) (torch's kaiming_uniform_(a=sqrt(5)),
    the published LoRA's init of `lora_down`). `lora_up` is not zero, as in
    an adapter that has trained: at rank 4 and alpha 1 each LoRA layer then
    adds about 8% to its base layer's output, so the LoRA's route through the
    step (folded in the inner denoise, off in the 3B reference forward, on in
    the target forward) shows in every compared number."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[k]) for k in names)
    flat = torch.rand(total, generator=generator(seed, "lora", device), device=device)
    out, offset = {}, 0
    for k in names:
        shape = shapes[k]
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        out[k] = flat[offset:offset + n].view(shape) * (2 * bound) - bound
        offset += n
    return out


PROMPTS = ("target", "positive", "neutral", "unconditional")


def embeddings(seed: int, device, context_dim: int, tokens: int,
               pooled_dim: int | None) -> dict:
    """The four prompts' text embeddings (1, tokens, context_dim), N(0, 1)
    float32, and with `pooled_dim` (SDXL) their pooled embeddings (1,
    pooled_dim), drawn after them."""
    g = generator(seed, "embeds", device)
    text = torch.randn((len(PROMPTS), 1, tokens, context_dim), generator=g, device=device)
    out = {"text": dict(zip(PROMPTS, text.unbind(0))), "pooled": None}
    if pooled_dim:
        pooled = torch.randn((len(PROMPTS), 1, pooled_dim), generator=g, device=device)
        out["pooled"] = dict(zip(PROMPTS, pooled.unbind(0)))
    return out


class Latents:
    """Initial latents, one (B, 4, h, w) standard normal an iteration, from
    one stream."""

    def __init__(self, seed: int, device, shape: tuple):
        self.g = generator(seed, "latents", device)
        self.device, self.shape = device, shape

    def next(self) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.g, device=self.device)
