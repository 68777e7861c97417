"""Test/bench fixtures: randomly initialized model bundles.

Counterpart of `leco_tpu/testing.py`: a tiny UNet with a fake text encoder
that runs the whole train loop on the CPU in seconds, and a full-width
SD1.5 bundle with random weights for the card (training speed does not
depend on the weight values). Every draw comes from one seeded
`torch.Generator`; the fake encoder is seeded by the prompt's sha256 through
numpy.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional

import numpy as np
import torch

from leco_tpu_torch.lora import LoRAConv2d, LoRALinear, LoRASpec, apply_lora_spec
from leco_tpu_torch.models.unet import (
    UNet2DConditionModel,
    UNetConfig,
    sd15_config,
    tiny_unet_config,
)
from leco_tpu_torch.ops.attention import default_backend
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.train.trainer import ModelBundle


def fake_encode_fn(cross_attention_dim: int, device):
    """Deterministic pseudo-embedding per prompt string: the ESD objective
    only needs distinct, consistent embeddings."""

    def encode(prompt: str) -> torch.Tensor:
        digest = hashlib.sha256(prompt.encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:4], "little"))
        seq = rng.standard_normal((1, 77, cross_attention_dim), dtype=np.float32)
        return torch.from_numpy(seq).to(device)

    return encode


@torch.no_grad()
def init_unet_(unet: torch.nn.Module, generator: torch.Generator,
               param_dtype: torch.dtype) -> None:
    """LeCun-normal weights (std 1/sqrt(fan_in), the JAX package's
    initializer) and zero biases in `param_dtype`, drawn layer by layer in
    module order; norms stay fp32 at weight 1, bias 0."""
    for mod in unet.modules():
        if isinstance(mod, (LoRALinear, LoRAConv2d)):
            w = mod.weight
            fan_in = w[0].numel()
            mod.weight = torch.nn.Parameter(
                torch.randn(w.shape, generator=generator, device=w.device)
                .mul_(1.0 / math.sqrt(fan_in)).to(param_dtype)
            )
            if mod.bias is not None:
                mod.bias = torch.nn.Parameter(
                    torch.zeros(mod.bias.shape, device=w.device, dtype=param_dtype)
                )
    unet.requires_grad_(False)


def make_random_bundle(
    config: Optional[UNetConfig] = None,
    spec: Optional[LoRASpec] = None,
    scheduler_kind: str = "ddim",
    prediction_type: str = "epsilon",
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype = torch.float32,
    attn_backend: Optional[str] = None,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> ModelBundle:
    """Random-weight ModelBundle. Defaults to the tiny CPU test UNet; pass
    `config=sd15_config()` for the full width. The attention backend
    defaults to the device's (the kernels on CUDA)."""
    config = config or tiny_unet_config()
    spec = spec or LoRASpec(rank=4, alpha=1.0)
    device = torch.device(device)
    attn_backend = attn_backend or default_backend(device)
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    with torch.device(device):
        unet = UNet2DConditionModel(config, dtype=dtype, attn_backend=attn_backend)
    init_unet_(unet, generator, param_dtype)
    apply_lora_spec(unet, spec, generator)  # the new LoRA parameters train
    return ModelBundle(
        unet=unet,
        scheduler=NoiseScheduler(scheduler_kind, prediction_type),
        spec=spec,
        device=device,
        encode_fn=fake_encode_fn(config.cross_attention_dim, device),
    )


def make_sd15_bundle(dtype: torch.dtype = torch.bfloat16, **kw) -> ModelBundle:
    """Full-width SD1.5 bundle with random weights."""
    return make_random_bundle(config=sd15_config(), dtype=dtype,
                              param_dtype=dtype, **kw)
