"""LoRA layers, state-dict surgery and the AddNet export.

Counterpart of `leco_tpu/lora.py`. Every Linear and Conv2d of the UNet is a
`LoRALinear` / `LoRAConv2d`; `apply_lora_spec` adds the rank-r branch
(`lora_down`, `lora_up`, fp32 masters) to the layers whose dotted module
name the `LoRASpec` matches. A layer then runs in one of three modes, which
stand in for the JAX package's choice of parameter tree per call:

  * "on"     (default) W x + up(down(x)) * alpha/r, in the compute dtype —
              the differentiated target pass;
  * "off"    W x only — the LoRA-off reference predictions;
  * "folded" (W + up·down * alpha/r) x with the fold computed once
              (`folded_lora`, the JAX package's `fold_lora_params`) — the
              inner partial denoise, which reuses the same weights for every
              step under no_grad.

The LoRA ride-along concat GEMM of the JAX package (`lora.py:141-152`) is
not ported: its reason is the TPU's matrix-unit lane padding. The port
computes what the JAX package computes with `LECO_LORA_FUSE=0`.

The JAX package's opt-in kernel knobs reach the layers here:
`LoRALinear.geglu` is the GEGLU projection (`LECO_GEGLU`, `ops/geglu.py`);
`LoRAConv2d` takes a GroupNorm collapsed to an affine (`affine=(a, s)`, the
fused resnet of `ops/gn_conv.py`) and sends hot 3x3 convs to the
implicit-GEMM kernel under `LECO_CONV_BACKEND=gemm` (`ops/conv.py`). The
LoRA branch is added after either kernel.

The tree operations of the JAX package work on the port's flat trees
({"<layer>.lora_down": t, "<layer>.lora_up": t}): `scale_lora_tree` (the
AddNet weight), `fold_lora_params` and `compose_lora_params` (several LoRAs
folded into one base-shaped state dict), and `load_lora_weights` (an AddNet
file back into a tree, with the file-alpha rescale).

An upsampler conv (`pre_upsample`) takes the input before its nearest-2x
upsample and, with no LoRA branch on, runs as four 2x2 phase convolutions
at the input's resolution, as the JAX package's `LoRAConv` does.

Under a parallel context (`leco_tpu_torch.parallel`, set by the UNet's
`set_parallel`), a 3x3 conv whose call has its H split over sp takes its
neighbours' halo rows (`parallel/spatial.py`), and a Linear that
`parallel.sharding.shard_unet` cut to a tp share runs column- or
row-parallel with its LoRA factors sliced to match; without one, nothing
changes.

Export writes the A1111-AddNet / kohya layout,
`lora_unet_<path>.{lora_down.weight, lora_up.weight, alpha}`, to
`.safetensors` with a small writer of its own (8-byte little-endian header
length, JSON header, raw little-endian tensor bytes), and to a `torch.save`
file for any other extension (the reference's behaviour).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import mmap
import os
import re
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from leco_tpu_torch.ops import conv as conv_ops
from leco_tpu_torch.ops import geglu as geglu_ops
from leco_tpu_torch.ops import gn_conv
from leco_tpu_torch.parallel import sharding as tp_ops
from leco_tpu_torch.parallel import spatial

LORA_PREFIX_UNET = "lora_unet"
MODES = ("on", "off", "folded")

_TRANSFORMER_RE = re.compile(r"(^|\.)attentions\.\d+(\.|$)")
_CONV_BLOCK_RE = re.compile(r"(^|\.)(resnets\.\d+|downsamplers\.0|upsamplers\.0)(\.|$)")


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """Static LoRA network description."""

    rank: int = 4
    alpha: float = 1.0
    network_type: str = "lierla"  # or "c3lier"
    train_method: str = "full"

    @property
    def stored_alpha(self) -> float:
        """alpha falls back to the (unclamped) rank when 0/None
        (reference lora.py:86)."""
        return self.alpha if self.alpha else float(self.rank)

    def matches(self, name: str) -> bool:
        """Is the layer with dotted module name `name` a LoRA target? The
        same rule as the JAX package, on diffusers-style names."""
        m = self.train_method
        if m == "noxattn":
            if "attn2" in name or "time_embed" in name:
                return False
        elif m == "innoxattn":
            if "attn2" in name:
                return False
        elif m == "selfattn":
            if "attn1" not in name:
                return False
        elif m == "xattn":
            if "attn2" not in name:
                return False
        elif m != "full":
            raise NotImplementedError(f"train_method: {m} is not implemented.")

        in_transformer = bool(_TRANSFORMER_RE.search(name))
        if self.network_type == "lierla":
            return in_transformer
        if self.network_type == "c3lier":
            return in_transformer or bool(_CONV_BLOCK_RE.search(name))
        raise ValueError(f"unknown network type: {self.network_type}")


def _kaiming_down(shape, fan_in: int, generator, device) -> torch.Tensor:
    """torch kaiming_uniform_(a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (reference lora.py:91)."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


def _fold_weight(w, down, up, scale: float) -> torch.Tensor:
    """W + compose(down, up) * scale, summed in fp32 and rounded to W's
    dtype once (JAX `fold_lora_params`). Dense: up (out, r) @ down (r, in);
    conv: up (out, r, 1, 1) composed with down (r, in, kh, kw)."""
    if down.ndim == 4:
        delta = torch.einsum("or,rikl->oikl", up.flatten(1).float(), down.float())
    else:
        delta = up.float() @ down.float()
    return (w.float() + delta * scale).to(w.dtype)


class _LoRALayer(nn.Module):
    """Mode and branch bookkeeping shared by the two layer kinds."""

    lora_down: Optional[nn.Parameter]
    lora_up: Optional[nn.Parameter]
    parallel = None  # a parallel.context.ParallelContext, set by the UNet

    def _init_lora_state(self) -> None:
        self.lora_down = None
        self.lora_up = None
        self.lora_scale = 0.0
        self.mode = "on"
        self.folded: Optional[torch.Tensor] = None

    @property
    def has_lora(self) -> bool:
        return self.lora_down is not None

    def _weight(self) -> torch.Tensor:
        if self.has_lora and self.mode == "folded":
            return self.folded
        return self.weight

    def _branch_on(self) -> bool:
        return self.has_lora and self.mode == "on"

    def lora_factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(down, up) as this layer's share of the weight uses them."""
        return self.lora_down, self.lora_up

    def fold(self) -> None:
        self.folded = _fold_weight(self.weight, *self.lora_factors(), self.lora_scale)


class LoRALinear(_LoRALayer):
    """nn.Linear (weight (out, in), optional bias) in its own parameter
    dtype, computing in the input's dtype, with an optional LoRA branch
    `lora_down` (r, in) / `lora_up` (out, r). A tp-sharded layer holds
    its share of the base weight and the whole LoRA (`tp_role`, `tp_index`:
    its output rows or input columns)."""

    tp_role: Optional[str] = None
    tp_index: Optional[torch.Tensor] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._init_lora_state()

    def add_lora(self, spec: LoRASpec, generator: torch.Generator) -> None:
        r = spec.rank
        dev = self.weight.device
        self.lora_down = nn.Parameter(
            _kaiming_down((r, self.in_features), self.in_features, generator, dev)
        )
        self.lora_up = nn.Parameter(
            torch.zeros(self.out_features, r, device=dev, dtype=torch.float32)
        )
        self.lora_scale = spec.stored_alpha / r

    def lora_factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.tp_role == tp_ops.COLUMN:
            return self.lora_down, self.lora_up.index_select(0, self.tp_index)
        if self.tp_role == tp_ops.ROW:
            return self.lora_down.index_select(1, self.tp_index), self.lora_up
        return self.lora_down, self.lora_up

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_role is not None:
            return tp_ops.linear(self, x)
        dt = x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x, self._weight().to(dt), bias)
        if self._branch_on():
            delta = F.linear(F.linear(x, self.lora_down.to(dt)), self.lora_up.to(dt))
            y = y + delta * self.lora_scale
        return y

    def geglu(self, x: torch.Tensor) -> torch.Tensor:
        """This layer as the GEGLU projection (the JAX package's LoRADense
        with geglu=True, lora.py:220-260, without the ride-along): value *
        gelu_exact(gate) of its two output halves, the LoRA delta
        xd = (x down^T) * scale entering before the activation. The backend
        is `LECO_GEGLU`'s; "fused" takes the kernel where it supports x.
        Column-parallel under tp, its share is [value_local | gate_local]."""
        if self.tp_role is not None:
            x = tp_ops.column_input(self, x)
        dt = x.dtype
        xd = up = None
        if self._branch_on():
            down, up = self.lora_factors()
            xd = F.linear(x, down.to(dt)) * self.lora_scale
            up = up.to(dt)
        backend = geglu_ops.default_geglu_backend()
        if backend == "fused" and geglu_ops.supports(dt, x.device):
            fn = geglu_ops.geglu_fused
        elif backend == "split":
            fn = geglu_ops.geglu_split
        else:
            fn = geglu_ops.geglu_reference
        return fn(x, self._weight().to(dt), self.bias, xd, up)


class LoRAConv2d(_LoRALayer):
    """nn.Conv2d (weight (out, in, kh, kw), bias) with an optional LoRA
    branch: `lora_down` a conv with the base kernel, stride and padding
    (r, in, kh, kw), `lora_up` a 1x1 conv (out, r, 1, 1); r is clamped to
    min(rank, in, out) (reference lora.py:72)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 pre_upsample: bool = False):
        super().__init__()
        if pre_upsample and (kernel_size, stride, padding) != (3, 1, 1):
            raise ValueError("pre_upsample needs a 3x3, stride-1, pad-1 conv")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.pre_upsample = pre_upsample
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self._init_lora_state()

    def add_lora(self, spec: LoRASpec, generator: torch.Generator) -> None:
        r = min(spec.rank, self.in_channels, self.out_channels)
        k = self.kernel_size
        dev = self.weight.device
        self.lora_down = nn.Parameter(
            _kaiming_down((r, self.in_channels, k, k), self.in_channels * k * k,
                          generator, dev)
        )
        self.lora_up = nn.Parameter(
            torch.zeros(self.out_channels, r, 1, 1, device=dev, dtype=torch.float32)
        )
        self.lora_scale = spec.stored_alpha / r  # lora.py:86-87

    def _is_hot_3x3(self) -> bool:
        """The convs the kernels take (the JAX package's
        LoRAConv._is_hot_3x3): 3x3, stride 1, pad 1, with a bias, at least
        `HOT_MIN_CHANNELS` in and out."""
        return (self.kernel_size == 3 and self.stride == 1 and self.padding == 1
                and self.bias is not None
                and min(self.in_channels, self.out_channels) >= conv_ops.HOT_MIN_CHANNELS)

    def fuses_group_norm(self, x: torch.Tensor) -> bool:
        """May this conv take its input x through the fused GroupNorm-SiLU-
        conv (`forward(x, affine=...)`)? Only a hot 3x3 conv with no LoRA
        branch at all (the JAX package asks its static spec, not the call's
        mode), at a shape `gn_conv.supports`."""
        return (not self.has_lora and self._is_hot_3x3()
                and gn_conv.supports(x.shape, self.out_channels, x.dtype, x.device))

    def _halo(self) -> bool:
        """Does this call's input hold only this rank's rows of H?"""
        return (self.parallel is not None and self.parallel.spatial
                and self.kernel_size > 1)

    def _phase_conv_up2x(self, x: torch.Tensor, w: torch.Tensor,
                         halo: bool = False) -> torch.Tensor:
        """Nearest-2x upsample followed by this 3x3/s1/p1 conv, as four 2x2
        phase convolutions at x's resolution (the JAX package's
        `LoRAConv._phase_conv_up2x`, lora.py:347-381). Output phase (a, b)
        lands at upsampled pixel (2y+a, 2x+b); the duplicated rows fold tap
        rows {1,2} (a = 0) or {0,1} (a = 1) of the kernel together, and
        likewise the columns, and phase (a, b) reads x padded by a zero row
        above (a = 0) or below (a = 1) and a column left or right. The tap
        sums are taken in w's dtype, the compute dtype. The four convs run
        as one, over x padded on every side, with the four 2x2 kernels
        stacked along the output channels; phase (a, b) is then the window
        of its output that starts at (a, b). With `halo`, the rows above
        and below are the neighbour ranks' (zeros at the global edges)."""
        n, _, h, wd = x.shape
        kernels = []
        for a in (0, 1):
            rows = ((w[:, :, 0], w[:, :, 1] + w[:, :, 2]) if a == 0
                    else (w[:, :, 0] + w[:, :, 1], w[:, :, 2]))
            ka = torch.stack(rows, dim=2)  # (Cout, Cin, 2, 3)
            for b in (0, 1):
                cols = ((ka[..., 0], ka[..., 1] + ka[..., 2]) if b == 0
                        else (ka[..., 0] + ka[..., 1], ka[..., 2]))
                kernels.append(torch.stack(cols, dim=3))  # (Cout, Cin, 2, 2)
        xp = (F.pad(spatial.halo_rows(x, self.parallel), (1, 1)) if halo
              else F.pad(x, (1, 1, 1, 1)))
        y = F.conv2d(xp, torch.cat(kernels))  # (B, 4·Cout, H+1, W+1)
        y = y.unflatten(1, (2, 2, -1))
        out = y.new_empty((n, y.shape[3], 2 * h, 2 * wd))
        for a in (0, 1):
            for b in (0, 1):
                out[:, :, a::2, b::2] = y[:, a, b, :, a:a + h, b:b + wd]
        return out

    def forward(self, x: torch.Tensor, affine=None) -> torch.Tensor:
        """`affine=(a, s)`, where `fuses_group_norm(x)`: x is the
        un-normalised input of a GroupNorm(+SiLU) collapsed to the
        per-(batch, channel) affine (a, s), and the fused kernel applies
        silu(a·x + s) as it runs the conv.

        A `pre_upsample` conv takes x before its nearest-2x upsample. With
        its LoRA branch not on (no LoRA, mode off or folded) it runs the
        phase convolutions and never materialises the upsample; with the
        branch on (c3lier) the branch needs the upsampled input, so it is
        materialised and the conv runs as any other (the JAX package's
        choice, lora.py:384-399)."""
        dt = x.dtype
        halo = self._halo()
        if self.pre_upsample:
            if not self._branch_on():
                y = self._phase_conv_up2x(x, self._weight().to(dt), halo)
                return y if self.bias is None else y + self.bias.to(dt)[None, :, None, None]
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        if halo:
            return self._halo_conv(x)
        if affine is not None:
            a, s = affine
            return gn_conv.affine_silu_conv(
                x.contiguous(), a, s, self._weight().to(dt), self.bias.float())
        if (conv_ops.default_conv_backend() == "gemm" and self._is_hot_3x3()
                and conv_ops.supports(dt, x.device)):
            y = conv_ops.conv3x3(x.contiguous(), self._weight().to(dt), self.bias.float())
        else:
            bias = None if self.bias is None else self.bias.to(dt)
            y = F.conv2d(x, self._weight().to(dt), bias, self.stride, self.padding)
        if self._branch_on():
            h = F.conv2d(x, self.lora_down.to(dt), None, self.stride, self.padding)
            y = y + F.conv2d(h, self.lora_up.to(dt)) * self.lora_scale
        return y

    def _halo_conv(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's output rows from its input rows and the halo rows
        (`parallel/spatial.py`), the LoRA branch on the same rows."""
        dt = x.dtype
        rows, pad = spatial.conv_input(x, self.parallel, self.kernel_size, self.stride,
                                       self.padding)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(rows, self._weight().to(dt), bias, self.stride, pad)
        if self._branch_on():
            h = F.conv2d(rows, self.lora_down.to(dt), None, self.stride, pad)
            y = y + F.conv2d(h, self.lora_up.to(dt)) * self.lora_scale
        return y


# ---------------------------------------------------------------------------
# whole-model helpers
# ---------------------------------------------------------------------------


def lora_layers(model: nn.Module) -> Iterator[tuple[str, _LoRALayer]]:
    for name, mod in model.named_modules():
        if isinstance(mod, _LoRALayer) and mod.has_lora:
            yield name, mod


def apply_lora_spec(model: nn.Module, spec: LoRASpec,
                    generator: torch.Generator) -> int:
    """Add the LoRA branch to every layer `spec` matches; returns the count.
    Layers are visited in module order, so one generator seed gives one
    initialization."""
    n = 0
    for name, mod in model.named_modules():
        if isinstance(mod, _LoRALayer) and spec.matches(name):
            mod.add_lora(spec, generator)
            n += 1
    return n


def lora_parameters(model: nn.Module) -> dict[str, nn.Parameter]:
    """The trainable tree: {"<layer>.lora_down": p, "<layer>.lora_up": p}."""
    out = {}
    for name, mod in lora_layers(model):
        out[f"{name}.lora_down"] = mod.lora_down
        out[f"{name}.lora_up"] = mod.lora_up
    return out


@contextlib.contextmanager
def lora_mode(model: nn.Module, mode: str):
    """Run every LoRA layer of `model` in `mode` inside the block."""
    if mode not in MODES:
        raise ValueError(f"unknown LoRA mode {mode}")
    layers = [m for _, m in lora_layers(model)]
    for m in layers:
        m.mode = mode
    try:
        yield
    finally:
        for m in layers:
            m.mode = "on"


@contextlib.contextmanager
def folded_lora(model: nn.Module):
    """Fold each LoRA into its base weight once, run the block in "folded"
    mode, and drop the folded copies after it."""
    layers = [m for _, m in lora_layers(model)]
    with torch.no_grad():
        for m in layers:
            m.fold()
    try:
        with lora_mode(model, "folded"):
            yield
    finally:
        for m in layers:
            m.folded = None


# ---------------------------------------------------------------------------
# state-dict surgery (the JAX package's pytree functions, on flat dicts)
# ---------------------------------------------------------------------------


def split_lora_params(state: dict) -> tuple[dict, dict]:
    """Full state dict -> (base, lora) by leaf name."""
    base = {k: v for k, v in state.items() if not k.rsplit(".", 1)[-1].startswith("lora_")}
    lora = {k: v for k, v in state.items() if k.rsplit(".", 1)[-1].startswith("lora_")}
    return base, lora


def merge_params(base: dict, lora: dict) -> dict:
    return {**base, **lora}


def fold_lora_params(base: dict, lora: dict, spec: LoRASpec) -> dict:
    """(base, lora) -> a base-shaped state dict with every targeted weight
    replaced by W + compose(down, up) * (alpha / r)."""
    out = dict(base)
    for layer in sorted({k.rsplit(".", 1)[0] for k in lora}):
        down = lora[f"{layer}.lora_down"]
        up = lora[f"{layer}.lora_up"]
        r = down.shape[0]  # conv r may be clamped (lora.py:72)
        out[f"{layer}.weight"] = _fold_weight(
            base[f"{layer}.weight"], down, up, spec.stored_alpha / r
        )
    return out


def compose_lora_params(base: dict, loras, spec: LoRASpec) -> dict:
    """Fold several LoRAs into one base-shaped state dict (the multi-AddNet
    composition): `loras` is a list of (tree, multiplier) pairs, folded in
    order as W + m1·d1 + m2·d2 + ..., multiplier 0 skipped. Trees from files
    with other alphas come through `load_lora_weights(..., spec=spec)`,
    which puts them on this spec's alpha/rank scale."""
    out = base
    for tree, multiplier in loras:
        if multiplier == 0.0:
            continue
        out = fold_lora_params(out, scale_lora_tree(tree, multiplier), spec)
    return out


def scale_lora_tree(lora: dict, multiplier: float) -> dict:
    """The LoRA's contribution times `multiplier` (the AddNet weight): it is
    linear in `lora_up`, so only those leaves are scaled."""
    return {k: v * multiplier if k.endswith(".lora_up") else v for k, v in lora.items()}


def lora_module_names(lora: dict) -> list[str]:
    """Export-layer names 'lora_unet_<path>' per layer, checked unique (the
    reference's duplicate-name guard, lora.py:139-144)."""
    layers = sorted({k.rsplit(".", 1)[0] for k in lora})
    names = sorted({LORA_PREFIX_UNET + "_" + p.replace(".", "_") for p in layers})
    if len(names) != len(layers):
        raise ValueError(
            f"duplicated lora name after path join: {len(layers)} layers -> "
            f"{len(names)} names"
        )
    return names


def count_lora_modules(lora: dict) -> int:
    return len(lora_module_names(lora))


def export_lora_state(lora: dict, spec: LoRASpec,
                      save_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """{"<layer>.lora_down": t, ...} -> {AddNet key: CPU tensor}. The port
    already stores both factors in torch layout, so nothing is transposed."""
    state = {}
    for layer in sorted({k.rsplit(".", 1)[0] for k in lora}):
        name = LORA_PREFIX_UNET + "_" + layer.replace(".", "_")
        for part in ("lora_down", "lora_up"):
            t = lora[f"{layer}.{part}"].detach()
            state[f"{name}.{part}.weight"] = t.to("cpu", save_dtype).contiguous()
        state[f"{name}.alpha"] = torch.tensor(spec.stored_alpha, dtype=save_dtype)
    return dict(sorted(state.items()))


_ST_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}
_ST_FROM_NAME = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str | os.PathLike, tensors: dict[str, torch.Tensor],
                      metadata: Optional[dict[str, str]] = None,
                      fill: Optional[Callable[[str], torch.Tensor]] = None) -> None:
    """The safetensors format: u64-LE header length, JSON header (padded with
    spaces to 8 bytes), then each tensor's raw little-endian bytes, written
    one tensor at a time. With `fill`, `tensors` gives only each tensor's
    shape and dtype (meta tensors will do) and `fill(name)` makes its data
    as it is written, so no more than one tensor is held at a time."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _ST_DTYPES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, t in tensors.items():
            if fill is not None:
                t = fill(name)
                if t.dtype != tensors[name].dtype or t.shape != tensors[name].shape:
                    raise ValueError(f"fill({name!r}) gave {t.dtype} {tuple(t.shape)}")
            t = t.detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def read_safetensors(path: str | os.PathLike) -> tuple[dict[str, torch.Tensor], dict]:
    """-> (tensors on the CPU, metadata). The file is mapped once and each
    tensor copied out of the mapping into its own buffer: one copy per
    tensor, never the whole file twice."""
    out = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        n = int.from_bytes(mm[:8], "little")
        header = json.loads(mm[8 : 8 + n])
        metadata = header.pop("__metadata__", {})
        base = 8 + n
        for name, info in header.items():
            start, end = info["data_offsets"]
            buf = torch.empty(end - start, dtype=torch.uint8)
            if end > start:
                buf.numpy()[:] = np.frombuffer(mm, np.uint8, end - start, base + start)
            out[name] = buf.view(_ST_FROM_NAME[info["dtype"]]).reshape(info["shape"])
    return out, metadata


def save_lora_weights(file: str | os.PathLike, lora: dict, spec: LoRASpec,
                      save_dtype: torch.dtype = torch.float32,
                      metadata: Optional[dict[str, str]] = None) -> None:
    """AddNet `.safetensors`, or `torch.save` of the same dict for any other
    extension (reference lora.py:224-228)."""
    state = export_lora_state(lora, spec, save_dtype=save_dtype)
    file = os.fspath(file)
    if os.path.splitext(file)[1] == ".safetensors":
        write_safetensors(file, state, metadata)
    else:
        torch.save(state, file)


def load_lora_weights(file: str | os.PathLike, reference_lora: dict,
                      spec: Optional[LoRASpec] = None) -> dict:
    """An AddNet `.safetensors` -> a LoRA tree shaped like `reference_lora`
    ({"<layer>.lora_down": t, "<layer>.lora_up": t}, fp32, on the reference
    tensors' devices). A file name is resolved through the reference's
    layers, since an underscore in it may have been a dot or not; a layer
    that matches none raises KeyError. With `spec`, a layer whose file
    `.alpha` differs from `spec.stored_alpha` has its `lora_up` rescaled by
    alpha_file / stored_alpha, so that the model's scale stored_alpha / r
    applies the file's contribution."""
    state, _ = read_safetensors(file)
    layers = {k.rsplit(".", 1)[0] for k in reference_lora}
    by_name = {LORA_PREFIX_UNET + "_" + layer.replace(".", "_"): layer for layer in layers}
    alphas = {key[: -len(".alpha")]: float(v) for key, v in state.items()
              if key.endswith(".alpha")}
    out = {}
    for key, value in state.items():
        name = key.rsplit(".", 1)[0]
        if not name.endswith((".lora_down", ".lora_up")):
            continue  # the ".alpha" entries were read above
        file_layer, part = name.rsplit(".", 1)
        layer = by_name.get(file_layer)
        if layer is None:
            raise KeyError(f"LoRA key {key} does not match any model layer")
        v = value.float()
        if part == "lora_up" and spec is not None and file_layer in alphas:
            factor = alphas[file_layer] / spec.stored_alpha
            if factor != 1.0:
                v = v * factor
        ref = reference_lora[f"{layer}.{part}"]
        if v.shape != ref.shape:
            raise ValueError(f"LoRA key {key} has shape {tuple(v.shape)}, the model's "
                             f"{layer}.{part} {tuple(ref.shape)}")
        out[f"{layer}.{part}"] = v.to(ref.device)
    return {k: out[k] for k in reference_lora if k in out}
