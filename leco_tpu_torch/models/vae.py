"""The VAE decoder (the decoder half of diffusers' AutoencoderKL), NCHW.

Counterpart of `leco_tpu/models/vae.py`. Inference only decodes latents to
images (training never touches the VAE), so only the decoder is here:
post_quant_conv, conv_in, a mid block (resnet, single-head attention,
resnet), up blocks of `layers_per_block + 1` resnets without a time
embedding and a nearest-2x upsampler on all but the last, then GroupNorm,
SiLU and conv_out. Module names are diffusers' (`post_quant_conv.*`,
`decoder.*`, the attention's `to_q` ... `to_out.0`), so the decoder keys of
a diffusers `vae/` state dict load as they are (`models/loader.py`
`load_vae_decoder`; the legacy attention names go through
`models/convert.py::vae_decoder_state`).

Numerics follow the JAX package: every GroupNorm has eps 1e-6 and computes
in fp32 with fp32 parameters, returning the compute dtype; the attention
scales q by c^-0.5 before the product, takes the logits and the softmax in
fp32 and casts the probabilities back. Convs and projections compute in
the model's dtype. The upsamplers are the UNet's `Upsample2D` (phase
convolutions, no materialised upsample); the other convs are plain
`nn.Conv2d`, which no kernel knob reaches, as the JAX VAE's `nn.Conv`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from leco_tpu_torch.lora import LoRAConv2d
from leco_tpu_torch.models.unet import Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEDecoderConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # SD1/2; SDXL uses 0.13025


def sdxl_vae_config() -> VAEDecoderConfig:
    return VAEDecoderConfig(scaling_factor=0.13025)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with eps 1e-6, fp32 statistics and parameters; the result in
    the input's dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-6)

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class VAEResnetBlock(nn.Module):
    """ResnetBlock2D without the time embedding."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention with a residual (diffusers'
    Attention in the VAE mid block)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.einsum("bqc,bkc->bqk", q * c**-0.5, k).float()
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        y = self.to_out[0](torch.einsum("bqk,bkc->bqc", probs, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups),
                                      VAEResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups) for j in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEDecoderConfig):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))  # (512, 512, 256, 128)
        groups = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = VAEMidBlock(ch[0], groups)
        self.up_blocks = nn.ModuleList(
            [VAEUpBlock(ch[max(i - 1, 0)], out_ch, cfg.layers_per_block + 1, groups,
                        i != len(ch) - 1)
             for i, out_ch in enumerate(ch)])
        self.conv_norm_out = GroupNorm(groups, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, x):
        x = self.mid_block(self.conv_in(x))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    """latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in about [-1, 1], in
    `dtype`. Callers divide the latents by `config.scaling_factor` first.
    Conv and linear weights are held in `dtype`, norm parameters in fp32."""

    def __init__(self, config: VAEDecoderConfig = VAEDecoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        self.decoder = Decoder(config)
        for mod in self.modules():
            if isinstance(mod, LoRAConv2d):  # created empty; init as nn.Conv2d
                nn.init.kaiming_uniform_(mod.weight, a=5**0.5)
                nn.init.zeros_(mod.bias)
            if isinstance(mod, (nn.Conv2d, nn.Linear, LoRAConv2d)):
                mod.to(dtype)

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
