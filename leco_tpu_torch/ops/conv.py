"""3x3 stride-1 pad-1 convolution on the implicit-GEMM Hopper kernel.

Counterpart of `leco_tpu/ops/conv.py`. The TPU kernel `_conv_kernel` (nine
tap GEMMs over flat padded rows, fp32 accumulation, fp32 bias, one rounding)
becomes the `leco_conv3x3` entry point of
`leco_tpu_torch/kernels/csrc/conv3x3.cu`, which reads the port's NCHW
activations and OIHW weights as they are (no padding or layout copy).

`conv3x3` is differentiable as the JAX package's custom VJP is: dx is the
same kernel run on the spatially flipped, in/out-swapped weights; dw and db
are plain, and computed only when asked for (the base weights are frozen
in LECO training). The knob `LECO_CONV_BACKEND=gemm` (read at call time,
default "xla") sends the UNet's hot 3x3 convs here (`lora.LoRAConv2d`).
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


def conv3x3_gemm_plain(x, weight, bias=None):
    """`_conv_kernel` (conv.py:66-77): the conv of x with the weights in x's
    dtype, accumulated in fp32, plus the fp32 bias, rounded once."""
    y = F.conv2d(x.float(), weight.to(x.dtype).float(), None, 1, 1)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(x.dtype)


def conv_operands(name, x, weight, bias):
    """Check the operands of a conv kernel; -> (b, cin, h, w, cout)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {x.dtype} is not the kernel's bfloat16")
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"{name}: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} are not NCHW and (Cout, Cin, 3, 3)")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    dev = x.device
    launch.check(name, "x", x, torch.bfloat16, (b, cin, h, w), dev)
    launch.check(name, "weight", weight, torch.bfloat16, (cout, cin, 3, 3), dev)
    if bias is not None:
        launch.check(name, "bias", bias, torch.float32, (cout,), dev)
    return b, cin, h, w, cout


def conv3x3_gemm(x, weight, bias=None):
    """3x3/s1/p1 conv -> (B, Cout, H, W). Kernel: csrc/conv3x3.cu,
    `leco_conv3x3`. x (B, Cin, H, W) and weight (Cout, Cin, 3, 3) bf16,
    bias fp32 (Cout) or None."""
    if not x.is_cuda:
        return conv3x3_gemm_plain(x, weight, bias)
    name = "conv3x3_gemm"
    b, cin, h, w, cout = conv_operands(name, x, weight, bias)
    from leco_tpu_torch.kernels.build import library

    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    err = library().leco_conv3x3(
        x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, cin, h, w, cout, launch.stream(x),
    )
    launch.raise_on(name, err)
    conv3x3_gemm.launches += 1
    return out


KERNEL_WRAPPERS = (conv3x3_gemm,)
launch.reset(KERNEL_WRAPPERS)


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weights whose 3x3 conv is the input gradient of a 3x3/s1/p1 conv
    with `weight`: flipped in both spatial axes, in and out swapped."""
    return weight.flip(2, 3).transpose(0, 1).contiguous()


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
        dx = conv3x3_gemm(g, flip_weight(weight)) if need_x else None
        dw = None
        if need_w:
            dw = torch.nn.grad.conv2d_weight(x.float(), weight.shape, g.float(),
                                             padding=1).to(weight.dtype)
        db = g.float().sum(dim=(0, 2, 3)) if need_b and ctx.has_bias else None
        return dx, dw, db


def conv3x3(x, weight, bias=None):
    """Differentiable 3x3/s1/p1 conv on the kernel."""
    return Conv3x3.apply(x, weight, bias)
