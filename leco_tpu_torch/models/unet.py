"""UNet2DConditionModel for SD 1.x / 2.x in PyTorch, NCHW.

Counterpart of `leco_tpu/models/unet.py`, grown from the independent torch
UNet the parity tests use (`tests/torch_unet_ref.py`): pre-norm resnets with
the time embedding added between convs, Transformer2DModel with GN(eps 1e-6)
and conv-or-linear projections, pre-LN transformer blocks (attn1 -> attn2 ->
GEGLU FF), the skip stack popped in reverse, nearest-2x upsample before the
up conv (folded into it as phase convolutions where no LoRA branch is on),
and the [cos, sin] timestep sinusoid. Module names follow diffusers'
state_dict naming, so LoRA export keys are a path join and
`models/convert.py` maps the JAX parameter tree one to one.

Added over the test reference: every Linear and Conv2d is a LoRA layer
(`leco_tpu_torch.lora`); attention goes through `ops.attention` (the flash
kernels or the plain path); the JAX package's opt-in kernel configuration
(`LECO_CONV_BACKEND=gemm`, `LECO_RESNET_FUSED=1`, `LECO_TPU_FUSED_GN=1`,
`LECO_GEGLU=fused`, read at call time) reaches the fused kernels of
`ops/conv.py`, `ops/gn_conv.py`, `ops/group_norm.py` and `ops/geglu.py`; the
GEGLU's gelu is the JAX package's polynomial-erf `gelu_exact`; and a
compute dtype separate from the norms:
GroupNorm and LayerNorm keep fp32 parameters and fp32 statistics and hand
back the compute dtype, as the JAX package's FusedGroupNorm / LayerNorm do.
`checkpoint_unet=True` (the JAX package's `remat`, `nn.remat` over the down,
mid and up blocks) runs each of those blocks under
`torch.utils.checkpoint` while grad is enabled: its activations are not
kept, and the backward runs its forward again, kernels and all.
SDXL (`sdxl_config`, `addition_embed_type="text_time"`) adds the
micro-conditioning embedding: the sinusoids of the six `time_ids` at
`addition_time_embed_dim`, concatenated in fp32 after the pooled
`text_embeds`, through a TimestepEmbedding named `add_embedding` whose
output is added to the time embedding before any block runs.
A float64 UNet computes in float64, its norms' statistics and sinusoids
included (a reference for the fp32 and bf16 forwards; the GEGLU's
polynomial gelu rounds through fp32).
`set_parallel(ctx)` (`leco_tpu_torch.parallel.context`) makes the UNet run
sharded: each call cuts its share of the batch over dp and of H over sp,
runs the layers on it (3x3 convs with halo rows, GroupNorm statistics and
self-attention K/V over sp, `parallel/spatial.py`; the tp-sharded Linears of
`parallel/sharding.py`), the fused knobs' kernels included, and gathers the
output. Without it nothing changes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from leco_tpu_torch.lora import LoRAConv2d, LoRALinear
from leco_tpu_torch.ops import gn_conv
from leco_tpu_torch.ops import group_norm as gn_ops
from leco_tpu_torch.ops.attention import multi_head_attention
from leco_tpu_torch.parallel import spatial
from leco_tpu_torch.parallel.context import attach


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: tuple = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: tuple = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Union[int, tuple] = 1
    cross_attention_dim: int = 768
    # diffusers-legacy semantics: this is the *head count* per block
    attention_head_dim: Union[int, tuple] = 8
    use_linear_projection: bool = False
    upcast_attention: bool = False
    addition_embed_type: Optional[str] = None  # "text_time" for SDXL
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32

    def per_block(self, value) -> tuple:
        n = len(self.block_out_channels)
        if isinstance(value, (tuple, list)):
            if len(value) != n:
                raise ValueError(f"{value} has not {n} entries")
            return tuple(value)
        return (value,) * n

    @property
    def heads_per_block(self) -> tuple:
        return self.per_block(self.attention_head_dim)

    @property
    def tlayers_per_block(self) -> tuple:
        return self.per_block(self.transformer_layers_per_block)


def sd15_config() -> UNetConfig:
    """Stable Diffusion v1.x (SD1.4/1.5/WD1.3): 0.86B params."""
    return UNetConfig(cross_attention_dim=768, attention_head_dim=8)


def sd21_config() -> UNetConfig:
    """Stable Diffusion v2.x (768-v, base): 1024-d OpenCLIP context, heads
    (5, 10, 20, 20) so every head is 64 wide, linear projections, and the
    fp32 softmax upcast, which applies on the plain attention path only (the
    flash kernels keep their own fp32 softmax)."""
    return UNetConfig(
        cross_attention_dim=1024,
        attention_head_dim=(5, 10, 20, 20),
        use_linear_projection=True,
        upcast_attention=True,
    )


def sdxl_config() -> UNetConfig:
    """SDXL base: 2.6B params, 3 levels (the first without attention), the
    10-deep level-3 transformer stack (the mid block's too), 2048-d context
    (CLIP-L and bigG concatenated), linear projections, text_time."""
    return UNetConfig(
        sample_size=128,
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
        block_out_channels=(320, 640, 1280),
        transformer_layers_per_block=(1, 2, 10),
        cross_attention_dim=2048,
        attention_head_dim=(5, 10, 20),
        use_linear_projection=True,
        addition_embed_type="text_time",
    )


def tiny_unet_config(cross_attention_dim: int = 32) -> UNetConfig:
    """2-level, 8-channel UNet for CPU tests."""
    return UNetConfig(
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(8, 16),
        layers_per_block=1,
        cross_attention_dim=cross_attention_dim,
        attention_head_dim=2,
        norm_num_groups=4,
    )


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of statistics and sinusoids: fp32, or fp64 for fp64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def timestep_embedding(t: torch.Tensor, dim: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoid with flip_sin_to_cos=True, freq_shift=0: [cos | sin], in
    `dtype` (fp32, or fp64 for the float64 reference)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=dtype, device=t.device) / half
    emb = t.to(dtype)[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class GroupNorm(nn.Module):
    """GroupNorm (+ optional SiLU) with fp32 parameters and statistics; the
    output has the input's dtype. Under `LECO_TPU_FUSED_GN=1` it runs
    `ops.group_norm.fused_group_norm` (the kernel on bf16 CUDA tensors).
    `affine_only=True` returns instead the per-(batch, channel) affine (a, s)
    of GroupNorm(x + temb) for a conv that applies it with the SiLU (the JAX
    package's FusedGroupNorm(affine_only=True), the fused resnet)."""

    parallel = None  # set by UNet2DConditionModel.set_parallel

    def __init__(self, groups: int, channels: int, eps: float, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, affine_only: bool = False, temb=None):
        split = self.parallel is not None and self.parallel.spatial
        if affine_only:
            if temb is None:
                temb = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
            if split:
                return spatial.affine_from_gn(x, self.weight, self.bias, temb, self.groups,
                                              self.eps, self.parallel)
            return gn_conv.affine_from_gn(x, self.weight, self.bias, temb,
                                          self.groups, self.eps)
        fused = gn_ops.fused_enabled() and gn_ops.supports(x.dtype, x.device)
        if split and fused:
            return spatial.fused_group_norm(x, self.weight, self.bias, self.groups, self.eps,
                                            self.silu, self.parallel)
        if split:
            return spatial.group_norm(x, self.weight, self.bias, self.groups, self.eps,
                                      self.silu, stat_dtype(x.dtype), self.parallel)
        if fused:
            return gn_ops.fused_group_norm(x, self.weight, self.bias, self.groups,
                                           self.eps, self.silu)
        sd = stat_dtype(x.dtype)
        y = F.group_norm(x.to(sd), self.groups, self.weight.to(sd), self.bias.to(sd),
                         self.eps)
        if self.silu:
            y = F.silu(y)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and statistics, output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, dtype):
        sd = stat_dtype(x.dtype)
        y = F.layer_norm(x.to(sd), (x.shape[-1],), self.weight.to(sd), self.bias.to(sd),
                         self.eps)
        return y.to(dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, embed_dim):
        super().__init__()
        self.linear_1 = LoRALinear(in_dim, embed_dim)
        self.linear_2 = LoRALinear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, groups):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, 1e-5, silu=True)
        self.conv1 = LoRAConv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = LoRALinear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, 1e-5, silu=True)
        self.conv2 = LoRAConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (
            LoRAConv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        )

    def forward(self, x, temb):
        temb_p = self.time_emb_proj(F.silu(temb.to(x.dtype)))
        fused = gn_conv.enabled()  # LECO_RESNET_FUSED, per conv (unet.py:212-242)
        if fused and self.conv1.fuses_group_norm(x):
            # the GroupNorm collapses to an affine the conv kernel applies
            h = self.conv1(x, affine=self.norm1(x, affine_only=True))
        else:
            h = self.conv1(self.norm1(x))
        if fused and self.conv2.fuses_group_norm(h):
            # the temb add folds into norm2's affine analytically
            h = self.conv2(h, affine=self.norm2(h, affine_only=True, temb=temb_p))
        else:
            h = h + temb_p[:, :, None, None]
            h = self.conv2(self.norm2(h))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class Attention(nn.Module):
    parallel = None  # set by UNet2DConditionModel.set_parallel

    def __init__(self, dim, heads, ctx_dim=None, upcast=False, backend="xla"):
        super().__init__()
        self.heads, self.upcast, self.backend = heads, upcast, backend
        ctx_dim = ctx_dim or dim
        self.to_q = LoRALinear(dim, dim, bias=False)
        self.to_k = LoRALinear(ctx_dim, dim, bias=False)
        self.to_v = LoRALinear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([LoRALinear(dim, dim)])

    def forward(self, x, ctx=None):
        kv = x if ctx is None else ctx
        q, k, v = self.to_q(x), self.to_k(kv), self.to_v(kv)
        if self.parallel is not None and self.parallel.spatial:
            out = spatial.attention(q, k, v, self.heads, self.upcast, self.backend,
                                    self.parallel, self_attention=ctx is None)
        else:
            out = multi_head_attention(q, k, v, num_heads=self.heads, upcast=self.upcast,
                                       backend=self.backend)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = LoRALinear(dim, inner * 2)

    def forward(self, x):
        # value * gelu_exact(gate), on the backend LECO_GEGLU names
        return self.proj.geglu(x)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * 4), nn.Identity(), LoRALinear(dim * 4, dim)]
        )

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, ctx_dim, upcast, backend):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, None, upcast, backend)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, ctx_dim, upcast, backend)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        dt = x.dtype
        x = x + self.attn1(self.norm1(x, dt))
        x = x + self.attn2(self.norm2(x, dt), ctx)
        return x + self.ff(self.norm3(x, dt))


class Transformer2DModel(nn.Module):
    def __init__(self, ch, heads, depth, ctx_dim, groups, use_linear, upcast,
                 backend):
        super().__init__()
        self.use_linear = use_linear
        self.norm = GroupNorm(groups, ch, 1e-6)
        if use_linear:
            self.proj_in = LoRALinear(ch, ch)
            self.proj_out = LoRALinear(ch, ch)
        else:
            self.proj_in = LoRAConv2d(ch, ch, 1)
            self.proj_out = LoRAConv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ctx_dim, upcast, backend)
             for _ in range(depth)]
        )

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear:
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
            x = self.proj_in(x)
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, ctx)
        if self.use_linear:
            x = self.proj_out(x)
            x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
            x = self.proj_out(x)
        # the sum takes its first operand's layout: NCHW, which the kernels
        # downstream read (x is a channels_last view on the linear route)
        return residual + x


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = LoRAConv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-2x upsample then a 3x3 conv, the upsample folded into the
    conv (`LoRAConv2d(pre_upsample=True)`: phase convolutions unless a LoRA
    branch on the conv is on)."""

    def __init__(self, ch):
        super().__init__()
        self.conv = LoRAConv2d(ch, ch, 3, padding=1, pre_upsample=True)

    def forward(self, x):
        return self.conv(x)


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, layers, depth, heads, ctx_dim,
                 groups, use_linear, upcast, backend, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_dim, groups)
             for i in range(layers)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(out_ch, heads, depth, ctx_dim, groups,
                                use_linear, upcast, backend)
             for _ in range(layers)]
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None
        )

    def forward(self, x, temb, ctx):
        outputs = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), ctx)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class DownBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, layers, groups, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_dim, groups)
             for i in range(layers)]
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None
        )

    def forward(self, x, temb, ctx=None):
        outputs = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, ch, temb_dim, depth, heads, ctx_dim, groups, use_linear,
                 upcast, backend):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim, groups),
             ResnetBlock2D(ch, ch, temb_dim, groups)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(ch, heads, depth, ctx_dim, groups, use_linear,
                                upcast, backend)]
        )

    def forward(self, x, temb, ctx):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, in_chs, out_ch, temb_dim, depth, heads, ctx_dim, groups,
                 use_linear, upcast, backend, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_ch, temb_dim, groups) for c in in_chs]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(out_ch, heads, depth, ctx_dim, groups,
                                use_linear, upcast, backend) for _ in in_chs]
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None
        )

    def forward(self, x, res_states, temb, ctx):
        res_states = list(res_states)  # a checkpointed call runs twice on one list
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_states.pop()], dim=1)
            x = attn(resnet(x, temb), ctx)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock2D(nn.Module):
    def __init__(self, in_chs, out_ch, temb_dim, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_ch, temb_dim, groups) for c in in_chs]
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None
        )

    def forward(self, x, res_states, temb, ctx=None):
        res_states = list(res_states)  # a checkpointed call runs twice on one list
        for resnet in self.resnets:
            x = torch.cat([x, res_states.pop()], dim=1)
            x = resnet(x, temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------


class UNet2DConditionModel(nn.Module):
    """The SD denoising UNet: forward(sample (B, 4, H, W), timesteps (scalar
    or (B,)), encoder_hidden_states (B, 77, ctx), added_cond_kwargs=None)
    -> (B, 4, H, W) in the compute dtype. `added_cond_kwargs` is SDXL's
    {"text_embeds": (B, pooled), "time_ids": (B, 6)}, required there and
    ignored elsewhere. Parameters are created empty; fill them with
    `leco_tpu_torch.testing.init_unet_` or `load_state_dict`. Under a
    parallel context (`set_parallel`) the inputs and the output are the
    global tensors; `forward_local` runs on this rank's share."""

    parallel = None  # a parallel.context.ParallelContext

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32,
                 attn_backend: str = "xla", checkpoint_unet: bool = False):
        super().__init__()
        if cfg.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unknown addition_embed_type: {cfg.addition_embed_type}")
        self.cfg = cfg
        self.dtype = dtype
        self.checkpoint_unet = checkpoint_unet
        ch = cfg.block_out_channels
        heads = cfg.heads_per_block
        tlayers = cfg.tlayers_per_block
        temb_dim = ch[0] * 4
        n = len(ch)
        groups = cfg.norm_num_groups
        attn = dict(upcast=cfg.upcast_attention, backend=attn_backend)

        self.conv_in = LoRAConv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim)

        # down: track skip channels exactly as the stack accumulates
        self.down_blocks = nn.ModuleList()
        skip_chs = [ch[0]]
        in_ch = ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            is_final = i == n - 1
            if kind == "CrossAttnDownBlock2D":
                block = CrossAttnDownBlock2D(
                    in_ch, ch[i], temb_dim, cfg.layers_per_block, tlayers[i],
                    heads[i], cfg.cross_attention_dim, groups,
                    cfg.use_linear_projection, add_downsample=not is_final, **attn,
                )
            elif kind == "DownBlock2D":
                block = DownBlock2D(in_ch, ch[i], temb_dim, cfg.layers_per_block,
                                    groups, not is_final)
            else:
                raise ValueError(f"unknown down block: {kind}")
            self.down_blocks.append(block)
            skip_chs.extend([ch[i]] * cfg.layers_per_block)
            if not is_final:
                skip_chs.append(ch[i])
            in_ch = ch[i]

        self.mid_block = UNetMidBlock2DCrossAttn(
            ch[-1], temb_dim, tlayers[-1], heads[-1], cfg.cross_attention_dim,
            groups, cfg.use_linear_projection, **attn,
        )

        # up: resnet i input = current + popped skip channels
        self.up_blocks = nn.ModuleList()
        rev_ch = list(reversed(ch))
        rev_heads = list(reversed(heads))
        rev_tlayers = list(reversed(tlayers))
        cur = ch[-1]
        for i, kind in enumerate(cfg.up_block_types):
            is_final = i == n - 1
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(cur + skip_chs.pop())
                cur = rev_ch[i]
            if kind == "CrossAttnUpBlock2D":
                block = CrossAttnUpBlock2D(
                    in_chs, rev_ch[i], temb_dim, rev_tlayers[i], rev_heads[i],
                    cfg.cross_attention_dim, groups, cfg.use_linear_projection,
                    add_upsample=not is_final, **attn,
                )
            elif kind == "UpBlock2D":
                block = UpBlock2D(in_chs, rev_ch[i], temb_dim, groups, not is_final)
            else:
                raise ValueError(f"unknown up block: {kind}")
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm(groups, ch[0], 1e-5, silu=True)
        self.conv_out = LoRAConv2d(ch[0], cfg.out_channels, 3, padding=1)

    def set_attention_backend(self, backend: str) -> None:
        """Switch every attention layer between "flash" and "xla"."""
        for mod in self.modules():
            if isinstance(mod, Attention):
                mod.backend = backend

    def set_parallel(self, ctx) -> None:
        """Run sharded by `ctx` (a ParallelContext), or unsharded with None:
        the UNet and every layer that reads the context hold it."""
        attach(self, ctx)

    @property
    def is_xl(self) -> bool:
        return self.cfg.addition_embed_type == "text_time"

    def forward(self, sample, timesteps, encoder_hidden_states, added_cond_kwargs=None):
        if self.parallel is not None:
            return self.parallel.call(self.forward_local, sample, timesteps,
                                      encoder_hidden_states, added_cond_kwargs)[0]
        return self.forward_local(sample, timesteps, encoder_hidden_states, added_cond_kwargs)

    def forward_local(self, sample, timesteps, encoder_hidden_states, added_cond_kwargs=None):
        cfg = self.cfg
        sample = sample.to(self.dtype)
        ctx = encoder_hidden_states.to(self.dtype)
        b = sample.shape[0]
        sd = stat_dtype(self.dtype)
        t = torch.as_tensor(timesteps, dtype=sd, device=sample.device)
        t = torch.broadcast_to(torch.atleast_1d(t), (b,))
        emb = self.time_embedding(
            timestep_embedding(t, cfg.block_out_channels[0], sd).to(self.dtype)
        )
        if self.is_xl:
            if added_cond_kwargs is None:
                raise ValueError("an SDXL UNet needs added_cond_kwargs={'text_embeds', "
                                 "'time_ids'}")
            time_ids = added_cond_kwargs["time_ids"].to(sample.device)
            time_embeds = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim, sd).reshape(b, -1)
            # the JAX order: text_embeds to fp32, the concat, then the Dense
            # in the compute dtype
            add_embeds = torch.cat(
                [added_cond_kwargs["text_embeds"].to(sample.device, sd), time_embeds], dim=-1)
            if add_embeds.shape[-1] != cfg.projection_class_embeddings_input_dim:
                raise ValueError(
                    f"added embedding of width {add_embeds.shape[-1]}, the UNet wants "
                    f"{cfg.projection_class_embeddings_input_dim}")
            emb = emb + self.add_embedding(add_embeds.to(self.dtype))

        if self.checkpoint_unet and torch.is_grad_enabled():
            def run(block, *args):
                # the recomputation in the backward runs with this call's sharding
                fn = block if self.parallel is None else self.parallel.bound(block)
                return checkpoint(fn, *args, use_reentrant=False)
        else:
            def run(block, *args):
                return block(*args)

        sample = self.conv_in(sample)
        stack = [sample]
        for block in self.down_blocks:
            sample, res = run(block, sample, emb, ctx)
            stack.extend(res)
        sample = run(self.mid_block, sample, emb, ctx)
        for block in self.up_blocks:
            n_pop = cfg.layers_per_block + 1
            res, stack = stack[-n_pop:], stack[:-n_pop]
            sample = run(block, sample, res, emb, ctx)
        return self.conv_out(self.conv_norm_out(sample))
