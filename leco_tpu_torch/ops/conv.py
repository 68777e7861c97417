"""3x3 stride-1 pad-1 convolution on the implicit-GEMM Hopper kernel.

Counterpart of `leco_tpu/ops/conv.py`. The TPU kernel `_conv_kernel` (nine
tap GEMMs over flat padded rows, fp32 accumulation, fp32 bias, one rounding)
becomes the `leco_conv3x3` entry point of
`leco_tpu_torch/kernels/csrc/conv3x3.cu` (wgmma on TMA-staged tiles), which
reads the port's NCHW activations as they are; the weights go to it
repacked per tap, (9, Cout, Cin) (`pack_weight`), the JAX package's
`kernel.reshape(9, cin, cout)` transposed.

`conv3x3` is differentiable as the JAX package's custom VJP is: dx is the
same kernel run on the spatially flipped, in/out-swapped weights (the flip
folded into the repack); dw and db are plain, and computed only when asked
for (the base weights are frozen in LECO training). The knob
`LECO_CONV_BACKEND=gemm` (read at call time, default "xla") sends the
UNet's hot 3x3 convs here (`lora.LoRAConv2d`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from leco_tpu_torch.kernels import launch

# the hot-shape gate of the JAX package's LoRAConv._is_hot_3x3: SD's resnet
# and upsampler convs; thin convs (conv_in, conv_out) stay on cuDNN
HOT_MIN_CHANNELS = 128


def default_conv_backend() -> str:
    return os.environ.get("LECO_CONV_BACKEND", "xla")


def supports(dtype: torch.dtype, device: torch.device) -> bool:
    """May `conv3x3` take this input? On CUDA the kernel is bf16 only (fp32
    keeps the plain conv); on the CPU every dtype runs the kernel's plain
    version."""
    return torch.device(device).type != "cuda" or dtype == torch.bfloat16


def tile_plan(b: int, cin: int, h: int, w: int, cout: int, sms: int = 132) -> dict:
    """The kernel's tiling of a (B, Cin, H, W) -> Cout conv (what `launch` and
    `split_k` in conv3x3.cu pick): a block owns 128 output channels x 128
    pixels, `rows` image rows of `wb` columns; the staged input lines are
    `wb` pixels wide under a `swizzle`-byte TMA swizzle. W % 8 != 0 has no
    tensor map (a row stride must be a multiple of 16 bytes): route "fill",
    ordinary loads into the same layout at wb 16. When the blocks fill less
    than half of the card's `sms`, K (64-channel chunks) is split over a
    cluster of `splits` blocks."""
    if w % 8:
        route, wb = "fill", 16
    else:
        route, wb = "tma", 64 if w > 32 else 32 if w > 16 else 16
    rows = 128 // wb
    tiles = -(-h // rows) * -(-w // wb)
    blocks = b * tiles * -(-cout // 128)
    chunks = -(-cin // 64)
    splits = 1
    if 2 * blocks < sms:
        splits = max(1, min(8, sms // blocks, chunks))
        per = -(-chunks // splits)
        splits = -(-chunks // per)
    return {"route": route, "wb": wb, "rows": rows, "swizzle": 2 * wb,
            "pixel_tiles_per_image": tiles, "blocks": blocks, "chunks": chunks,
            "splits": splits}


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weights whose 3x3 conv is the input gradient of a 3x3/s1/p1 conv
    with `weight`: flipped in both spatial axes, in and out swapped."""
    return weight.flip(2, 3).transpose(0, 1).contiguous()


def pack_weight_plain(weight: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the kernel's (9, Cout, Cin8), tap 3·ky + kx,
    Cin8 = Cin rounded up to a multiple of 8 with zeros (a TMA stride is a
    multiple of 16 bytes). With `flip`, the weights of the input gradient
    (`flip_weight`): (9, Cin, Cout8)."""
    if flip:
        weight = weight.flip(2, 3).transpose(0, 1)
    cout, cin = weight.shape[:2]
    taps = weight.permute(2, 3, 0, 1).reshape(9, cout, cin)
    cin8 = -(-cin // 8) * 8
    if cin8 == cin:
        return taps.contiguous()
    packed = weight.new_zeros((9, cout, cin8))
    packed[:, :, :cin] = taps
    return packed


def pack_weight(weight: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """`pack_weight_plain` on the card: csrc/conv3x3.cu, `leco_conv3x3_pack`
    (a permuting copy, which PyTorch's strided copy does at a fraction of
    the memory rate). Part of the conv wrappers' launch; not counted apart."""
    if not weight.is_cuda:
        return pack_weight_plain(weight, flip)
    launch.check("pack_weight", "weight", weight, torch.bfloat16, tuple(weight.shape),
                 weight.device)
    cout, cin = weight.shape[:2]
    rows, cols = (cin, cout) if flip else (cout, cin)
    from leco_tpu_torch.kernels.build import library

    out = torch.empty((9, rows, -(-cols // 8) * 8), dtype=weight.dtype, device=weight.device)
    err = library().leco_conv3x3_pack(weight.data_ptr(), out.data_ptr(), cout, cin, int(flip),
                                      launch.stream(weight))
    launch.raise_on("pack_weight", err)
    return out


def conv3x3_gemm_plain(x, weight, bias=None, flip: bool = False):
    """`_conv_kernel` (conv.py:66-77): the conv of x with the weights in x's
    dtype, accumulated in fp32, plus the fp32 bias, rounded once. With
    `flip`, the conv with `flip_weight(weight)`."""
    if flip:
        weight = flip_weight(weight)
    y = F.conv2d(x.float(), weight.to(x.dtype).float(), None, 1, 1)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(x.dtype)


def conv_operands(name, x, weight, bias, flip: bool = False):
    """Check the operands of a conv kernel (x on the 16-byte boundary that
    its tensor map needs); -> (b, cin, h, w, cout). With `flip`, weight is
    a forward conv's OIHW weight, (Cin, Cout, 3, 3) of this conv, which
    runs with `flip_weight(weight)`."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {x.dtype} is not the kernel's bfloat16")
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"{name}: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} are not NCHW and (Cout, Cin, 3, 3)")
    b, cin, h, w = x.shape
    cout = weight.shape[1] if flip else weight.shape[0]
    dev = x.device
    launch.check(name, "x", x, torch.bfloat16, (b, cin, h, w), dev, aligned=True)
    launch.check(name, "weight", weight, torch.bfloat16,
                 (cin, cout, 3, 3) if flip else (cout, cin, 3, 3), dev)
    if bias is not None:
        launch.check(name, "bias", bias, torch.float32, (cout,), dev)
    return b, cin, h, w, cout


def conv3x3_gemm(x, weight, bias=None, flip: bool = False):
    """3x3/s1/p1 conv -> (B, Cout, H, W). Kernel: csrc/conv3x3.cu,
    `leco_conv3x3`. x (B, Cin, H, W) and weight (Cout, Cin, 3, 3) bf16,
    bias fp32 (Cout) or None; with `flip`, the conv with
    `flip_weight(weight)` (the input gradient), flipped in the repack."""
    if not x.is_cuda:
        return conv3x3_gemm_plain(x, weight, bias, flip)
    name = "conv3x3_gemm"
    b, cin, h, w, cout = conv_operands(name, x, weight, bias, flip)
    from leco_tpu_torch.kernels.build import library

    packed = pack_weight(weight, flip)
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    err = library().leco_conv3x3(
        x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, cin, h, w, cout, launch.stream(x),
    )
    launch.raise_on(name, err)
    conv3x3_gemm.launches += 1
    return out


KERNEL_WRAPPERS = (conv3x3_gemm,)
launch.reset(KERNEL_WRAPPERS)


class Conv3x3(torch.autograd.Function):
    """The JAX package's `conv3x3` custom VJP (conv.py:154-190)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv3x3_gemm(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g = g.contiguous()
        dx = conv3x3_gemm(g, weight, flip=True) if need_x else None
        dw = None
        if need_w:
            dw = torch.nn.grad.conv2d_weight(x.float(), weight.shape, g.float(),
                                             padding=1).to(weight.dtype)
        db = g.float().sum(dim=(0, 2, 3)) if need_b and ctx.has_bias else None
        return dx, dw, db


def conv3x3(x, weight, bias=None):
    """Differentiable 3x3/s1/p1 conv on the kernel."""
    return Conv3x3.apply(x, weight, bias)
