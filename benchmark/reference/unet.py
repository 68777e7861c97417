"""The benchmark's plain reference UNet2DConditionModel (SD1.x and SDXL).

Written from the published diffusers architecture, independent of the
program: pre-norm resnets with the time embedding added between the convs,
Transformer2DModel with GroupNorm (eps 1e-6) and conv or linear
projections, pre-LN transformer blocks (self-attention, cross-attention,
GEGLU feed-forward with the exact erf gelu), the skip stack popped in
reverse, nearest-2x upsampling before the up conv, the [cos, sin] timestep
sinusoid, and SDXL's text_time added embedding. Module names follow
diffusers' state_dict, so one dict of weights fills this model and the
program alike.

Every Linear and Conv2d may carry a LoRA branch (`lora_down`, `lora_up`,
scale alpha / r) and runs in the model's mode: "on" (W x + up(down(x)) *
scale), "off" (W x) or "folded" ((W + up·down * scale) x). Attention is the
plain product-softmax-product. Every operand of a matrix product or
convolution passes through the model's `round_operand` first: the identity
for the reference itself, and a rounding to a lower precision for the
control (`reference.precision`). Norms, the softmax and the sinusoids are
float32 throughout.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# a lierla LoRA sits on every Linear and Conv2d inside a transformer
# (`attentions.<i>`), by the published LoRA network's rule
_TRANSFORMER = re.compile(r"(^|\.)attentions\.\d+(\.|$)")


@dataclasses.dataclass(frozen=True)
class UNetSizes:
    """The fields of a diffusers `unet/config.json` this model reads."""

    block_out_channels: tuple
    down_block_types: tuple
    up_block_types: tuple
    layers_per_block: int
    cross_attention_dim: int
    attention_head_dim: tuple  # diffusers' legacy meaning: heads per block
    transformer_layers_per_block: tuple
    use_linear_projection: bool
    norm_num_groups: int = 32
    in_channels: int = 4
    out_channels: int = 4
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @classmethod
    def from_config(cls, unet: dict) -> "UNetSizes":
        n = len(unet["block_out_channels"])

        def per_block(v):
            return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

        return cls(
            block_out_channels=tuple(unet["block_out_channels"]),
            down_block_types=tuple(unet["down_block_types"]),
            up_block_types=tuple(unet["up_block_types"]),
            layers_per_block=unet["layers_per_block"],
            cross_attention_dim=unet["cross_attention_dim"],
            attention_head_dim=per_block(unet["attention_head_dim"]),
            transformer_layers_per_block=per_block(unet.get("transformer_layers_per_block", 1)),
            use_linear_projection=bool(unet.get("use_linear_projection", False)),
            norm_num_groups=unet.get("norm_num_groups", 32),
            in_channels=unet.get("in_channels", 4),
            out_channels=unet.get("out_channels", 4),
            addition_embed_type=unet.get("addition_embed_type"),
            addition_time_embed_dim=unet.get("addition_time_embed_dim", 256),
            projection_class_embeddings_input_dim=unet.get(
                "projection_class_embeddings_input_dim", 2816),
        )

    @property
    def pooled_dim(self) -> int:
        return self.projection_class_embeddings_input_dim - 6 * self.addition_time_embed_dim


class Run:
    """What every layer of one model reads per call: the LoRA mode and the
    rounding of matrix-product operands."""

    def __init__(self):
        self.mode = "on"
        self.round_operand: Callable[[torch.Tensor], torch.Tensor] = lambda t: t


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class _LoRA(nn.Module):
    run: Run

    def _init_lora(self):
        self.lora_down = None
        self.lora_up = None
        self.lora_scale = 0.0

    def add_lora(self, rank: int, alpha: float, down_shape: tuple, up_shape: tuple,
                 device) -> None:
        self.lora_down = nn.Parameter(torch.zeros(down_shape, device=device))
        self.lora_up = nn.Parameter(torch.zeros(up_shape, device=device))
        self.lora_scale = (alpha if alpha else float(rank)) / down_shape[0]

    def _weight(self) -> torch.Tensor:
        if self.lora_down is not None and self.run.mode == "folded":
            up, down = self.lora_up.flatten(1), self.lora_down
            delta = (up @ down.flatten(1)).reshape(self.weight.shape)
            return self.weight + delta * self.lora_scale
        return self.weight

    def _branch(self) -> bool:
        return self.lora_down is not None and self.run.mode == "on"


class Linear(_LoRA):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._init_lora()

    def lora_shapes(self, rank: int) -> tuple[tuple, tuple]:
        return (rank, self.in_features), (self.out_features, rank)

    def forward(self, x):
        r = self.run.round_operand
        y = F.linear(r(x), r(self._weight()), self.bias)
        if self._branch():
            y = y + F.linear(r(F.linear(r(x), r(self.lora_down))), r(self.lora_up)) \
                * self.lora_scale
        return y


class Conv2d(_LoRA):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.in_ch, self.out_ch, self.kernel = in_ch, out_ch, kernel
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self._init_lora()

    def lora_shapes(self, rank: int) -> tuple[tuple, tuple]:
        r = min(rank, self.in_ch, self.out_ch)
        return (r, self.in_ch, self.kernel, self.kernel), (self.out_ch, r, 1, 1)

    def forward(self, x):
        r = self.run.round_operand
        y = F.conv2d(r(x), r(self._weight()), self.bias, self.stride, self.padding)
        if self._branch():
            h = F.conv2d(r(x), r(self.lora_down), None, self.stride, self.padding)
            y = y + F.conv2d(r(h), r(self.lora_up)) * self.lora_scale
        return y


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, embed_dim):
        super().__init__()
        self.linear_1 = Linear(in_dim, embed_dim)
        self.linear_2 = Linear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-5)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-5)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class Attention(nn.Module):
    run: Run

    def __init__(self, dim, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        ctx_dim = ctx_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, n, c = q.shape
        d = c // self.heads
        r = self.run.round_operand

        def split(t):
            return t.reshape(b, -1, self.heads, d).transpose(1, 2)

        scores = r(split(q) * d ** -0.5) @ r(split(k)).transpose(-1, -2)
        probs = torch.softmax(scores, dim=-1)
        o = (r(probs) @ r(split(v))).transpose(1, 2).reshape(b, n, c)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, ch, heads, depth, ctx_dim, groups, use_linear):
        super().__init__()
        self.use_linear = use_linear
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        if use_linear:
            self.proj_in = Linear(ch, ch)
            self.proj_out = Linear(ch, ch)
        else:
            self.proj_in = Conv2d(ch, ch, 1)
            self.proj_out = Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ctx_dim) for _ in range(depth)])

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, ctx)
        if self.use_linear:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return x + residual


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, layers, depth, heads, ctx_dim, groups,
                 use_linear, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch,
                                                    temb_dim, groups) for i in range(layers)])
        self.attentions = nn.ModuleList([Transformer2DModel(out_ch, heads, depth, ctx_dim,
                                                            groups, use_linear)
                                         for _ in range(layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None

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
        self.resnets = nn.ModuleList([ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch,
                                                    temb_dim, groups) for i in range(layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None

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
    def __init__(self, ch, temb_dim, depth, heads, ctx_dim, groups, use_linear):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, temb_dim, groups),
                                      ResnetBlock2D(ch, ch, temb_dim, groups)])
        self.attentions = nn.ModuleList([Transformer2DModel(ch, heads, depth, ctx_dim, groups,
                                                            use_linear)])

    def forward(self, x, temb, ctx):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, in_chs, out_ch, temb_dim, depth, heads, ctx_dim, groups, use_linear,
                 add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, out_ch, temb_dim, groups)
                                      for c in in_chs])
        self.attentions = nn.ModuleList([Transformer2DModel(out_ch, heads, depth, ctx_dim,
                                                            groups, use_linear)
                                         for _ in in_chs])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, res_states, temb, ctx):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_states.pop()], dim=1)
            x = attn(resnet(x, temb), ctx)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock2D(nn.Module):
    def __init__(self, in_chs, out_ch, temb_dim, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, out_ch, temb_dim, groups)
                                      for c in in_chs])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, res_states, temb, ctx=None):
        for resnet in self.resnets:
            x = torch.cat([x, res_states.pop()], dim=1)
            x = resnet(x, temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet(nn.Module):
    """forward(sample (B, 4, h, w), timestep (a float), text (B, 77, ctx),
    added {"text_embeds", "time_ids"} or None) -> (B, 4, h, w), float32."""

    def __init__(self, sizes: UNetSizes):
        super().__init__()
        self.sizes = sizes
        ch = sizes.block_out_channels
        heads = sizes.attention_head_dim
        tlayers = sizes.transformer_layers_per_block
        temb_dim = ch[0] * 4
        n = len(ch)
        groups = sizes.norm_num_groups
        ctx_dim = sizes.cross_attention_dim
        lin = sizes.use_linear_projection

        self.conv_in = Conv2d(sizes.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        if sizes.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(sizes.projection_class_embeddings_input_dim,
                                                   temb_dim)
        self.down_blocks = nn.ModuleList()
        skip_chs = [ch[0]]
        in_ch = ch[0]
        for i, kind in enumerate(sizes.down_block_types):
            last = i == n - 1
            if kind == "CrossAttnDownBlock2D":
                block = CrossAttnDownBlock2D(in_ch, ch[i], temb_dim, sizes.layers_per_block,
                                             tlayers[i], heads[i], ctx_dim, groups, lin,
                                             not last)
            elif kind == "DownBlock2D":
                block = DownBlock2D(in_ch, ch[i], temb_dim, sizes.layers_per_block, groups,
                                    not last)
            else:
                raise ValueError(f"unknown down block {kind}")
            self.down_blocks.append(block)
            skip_chs.extend([ch[i]] * sizes.layers_per_block)
            if not last:
                skip_chs.append(ch[i])
            in_ch = ch[i]
        self.mid_block = UNetMidBlock2DCrossAttn(ch[-1], temb_dim, tlayers[-1], heads[-1],
                                                 ctx_dim, groups, lin)
        self.up_blocks = nn.ModuleList()
        rev_ch, rev_heads, rev_tl = ch[::-1], heads[::-1], tlayers[::-1]
        cur = ch[-1]
        for i, kind in enumerate(sizes.up_block_types):
            last = i == n - 1
            in_chs = []
            for _ in range(sizes.layers_per_block + 1):
                in_chs.append(cur + skip_chs.pop())
                cur = rev_ch[i]
            if kind == "CrossAttnUpBlock2D":
                block = CrossAttnUpBlock2D(in_chs, rev_ch[i], temb_dim, rev_tl[i], rev_heads[i],
                                           ctx_dim, groups, lin, not last)
            elif kind == "UpBlock2D":
                block = UpBlock2D(in_chs, rev_ch[i], temb_dim, groups, not last)
            else:
                raise ValueError(f"unknown up block {kind}")
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], sizes.out_channels, 3, padding=1)

        self.run = Run()
        for m in self.modules():
            if isinstance(m, (_LoRA, Attention)):
                m.run = self.run

    def lora_layers(self) -> dict[str, _LoRA]:
        """The layers a lierla LoRA covers, by dotted name."""
        return {name: m for name, m in self.named_modules()
                if isinstance(m, _LoRA) and _TRANSFORMER.search(name)}

    def add_lora(self, rank: int, alpha: float) -> dict[str, nn.Parameter]:
        """Give every lierla layer its branch (zeros); -> the trainable
        tree {"<layer>.lora_down": p, "<layer>.lora_up": p}."""
        tree = {}
        for name, m in self.lora_layers().items():
            down, up = m.lora_shapes(rank)
            m.add_lora(rank, alpha, down, up, m.weight.device)
            tree[f"{name}.lora_down"] = m.lora_down
            tree[f"{name}.lora_up"] = m.lora_up
        return tree

    def forward(self, sample, timestep, text, added=None):
        s = self.sizes
        b = sample.shape[0]
        t = torch.full((b,), float(timestep), dtype=torch.float32, device=sample.device)
        emb = self.time_embedding(timestep_embedding(t, s.block_out_channels[0]))
        if s.addition_embed_type == "text_time":
            time_embeds = timestep_embedding(added["time_ids"].reshape(-1),
                                             s.addition_time_embed_dim).reshape(b, -1)
            emb = emb + self.add_embedding(
                torch.cat([added["text_embeds"].float(), time_embeds], dim=-1))
        x = self.conv_in(sample)
        stack = [x]
        for block in self.down_blocks:
            x, res = block(x, emb, text)
            stack.extend(res)
        x = self.mid_block(x, emb, text)
        for block in self.up_blocks:
            n_pop = s.layers_per_block + 1
            res, stack = stack[-n_pop:], stack[:-n_pop]
            x = block(x, res, emb, text)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def shapes(sizes: UNetSizes, rank: int) -> tuple[dict, dict]:
    """({diffusers parameter name: shape} of the base weights, {"<layer>.
    lora_down" / ".lora_up": shape} of a rank-`rank` lierla LoRA)."""
    with torch.device("meta"):
        unet = UNet(sizes)
    weights = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    lora = {}
    for name, m in unet.lora_layers().items():
        down, up = m.lora_shapes(rank)
        lora[f"{name}.lora_down"], lora[f"{name}.lora_up"] = down, up
    return weights, lora


def build(sizes: UNetSizes, weights: dict[str, torch.Tensor], rank: int, alpha: float,
          lora: dict[str, torch.Tensor]) -> tuple[UNet, dict[str, nn.Parameter]]:
    """The reference in float32 on the weights' device: `weights` (every
    base parameter by name) and the LoRA tree `lora` copied in. -> (model,
    its trainable LoRA tree)."""
    with torch.device("meta"):
        unet = UNet(sizes)
    for name, value in weights.items():
        module_name, leaf = name.rsplit(".", 1)
        setattr(unet.get_submodule(module_name), leaf,
                nn.Parameter(value.detach().float().clone(), requires_grad=False))
    tree = unet.add_lora(rank, alpha)
    with torch.no_grad():
        for name, p in tree.items():
            p.copy_(lora[name])
    return unet, tree
