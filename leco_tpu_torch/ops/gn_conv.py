"""GroupNorm(+time embedding)+SiLU+3x3 conv: the fused resnet half-block.

Counterpart of `leco_tpu/ops/gn_conv.py`. The SD resnet half-block is
`conv3x3(silu(groupnorm(x [+ temb])))`. Here, as in the JAX package:

  * the GroupNorm collapses outside the kernel into a per-(batch, channel)
    affine (a, s) (`affine_from_gn`): statistics from one fp32-accumulated
    channel-sum pass, and the resnet's `h + temb` folded in analytically
    (E[(x+t)²] = E[x²] + 2tE[x] + t², per-channel scalars), so the temb add
    never touches device memory;
  * the kernel applies silu(a·x + s) once to each element of its staged
    input tile, in place in shared memory, and runs the 3x3 conv on it: the
    TPU kernel `_gnconv_kernel` becomes the `leco_gnconv3x3` entry point of
    `leco_tpu_torch/kernels/csrc/conv3x3.cu` (the conv core of
    `ops/conv.py`, weights repacked by `conv.pack_weight`).

Not carried over: the v5e `_TUNED` table and `_dispatch`, the lane padding
of Cin/Cout to multiples of 128, the gridded Cin and the VMEM budget, which
are all TPU artifacts. `supports()` is the JAX package's shape gate with
its split at 16 x 16, which the H100 keeps (`MAX_FUSED_SIDE`).

Backward: autograd through `_conv_reference` (the JAX `_vjp_bwd`); the
gradient of x through the statistics comes from autograd of
`affine_from_gn`. Layout is the port's NCHW; a and s are fp32 (B, C). The
knob `LECO_RESNET_FUSED=1` (read at call time) turns the path on in
`models/unet.py::ResnetBlock2D`.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from leco_tpu_torch.kernels import launch
from leco_tpu_torch.ops.conv import conv_operands, pack_weight
from leco_tpu_torch.ops.group_norm import group_norm_silu_ref, recompute_grads


def enabled() -> bool:
    return os.environ.get("LECO_RESNET_FUSED", "0") == "1"


# Above 16 x 16 the knob takes the unfused route, as the JAX gate does
# (gn_conv.py:179-182; its v5e table admits one such shape). On an H100,
# with the rest of the fused configuration on (the GroupNorm kernel, then
# conv3x3), that route beat the kernel route at every resnet conv above 16 x
# 16 of SD1.5, SD2.1 and SDXL, by 1.2-2.2x (`python -m
# leco_tpu_torch.kernels.time_gates`, PERF.md section 6). The gate follows
# that configuration, whose knobs are set together; against cuDNN's conv
# (every other knob off) the kernel route wins 15 of those 44 shapes.
MAX_FUSED_SIDE = 16


def supports(shape, cout: int, dtype: torch.dtype, device: torch.device) -> bool:
    """The JAX package's hot-shape gate (gn_conv.py:443-455) on an NCHW
    shape: 4 <= h, w <= `MAX_FUSED_SIDE` and Cin, Cout >= 128 (the caller
    has checked that the conv is 3x3/s1/p1 with a bias). On CUDA the kernel
    is bf16 only."""
    if len(shape) != 4:
        return False
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        return False
    _, c, h, w = shape
    return (4 <= h <= MAX_FUSED_SIDE and 4 <= w <= MAX_FUSED_SIDE
            and c >= 128 and cout >= 128)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def affine_from_gn(x, gn_scale, gn_bias, temb, num_groups: int, eps: float):
    """Differentiable (a, s), fp32 (B, C), with
    a·x + s == groupnorm(x + temb[:, :, None, None]) * gn_scale + gn_bias.
    `_gn_affine` (gn_conv.py:368-398): sums over (H, W) accumulated in fp32,
    the x·x product in x's dtype, temb folded in through the sums."""
    b, c, h, w = x.shape
    cg = c // num_groups
    n = h * w * cg
    hw = h * w
    s1c = x.sum(dim=(2, 3), dtype=torch.float32)
    s2c = (x * x).sum(dim=(2, 3), dtype=torch.float32)
    t = temb.float()
    s1c = s1c + hw * t
    s2c = s2c + 2.0 * t * (s1c - hw * t) + hw * t * t
    s1 = s1c.reshape(b, num_groups, cg).sum(-1)
    s2 = s2c.reshape(b, num_groups, cg).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = gn_scale.float()[None, :] * inv.repeat_interleave(cg, dim=1)
    s = gn_bias.float()[None, :] + (t - mean.repeat_interleave(cg, dim=1)) * a
    return a, s


def apply_affine_silu(x, a, s, with_silu: bool = True):
    """silu(a·x + s) in fp32, rounded to x's dtype: the kernel's prologue,
    for its plain version and the backward."""
    y = x.float() * _bcast(a) + _bcast(s)
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _conv_reference(x, a, s, weight, bias, with_silu: bool = True):
    """conv3x3(silu(a·x + s)) + bias in plain ops (the backward and the
    tests), everything in x's dtype."""
    y = apply_affine_silu(x, a, s, with_silu)
    return F.conv2d(y, weight.to(x.dtype), None, 1, 1) + _bcast(bias.to(x.dtype)[None])


def _reference(x, gn_scale, gn_bias, temb, weight, bias, num_groups: int,
               eps: float, with_silu: bool = True):
    """The unfused composition (tests): temb add, GroupNorm(+SiLU), conv.
    The JAX package normalises with `group_norm_silu_sum`; this takes the
    two-pass reference, the same function to fp32 rounding."""
    xt = x + _bcast(temb.to(x.dtype))
    y = group_norm_silu_ref(xt, gn_scale, gn_bias, num_groups, eps, with_silu)
    return F.conv2d(y, weight.to(x.dtype), None, 1, 1) + _bcast(bias.to(x.dtype)[None])


# ---------------------------------------------------------------------------
# the kernel: plain version and wrapper
# ---------------------------------------------------------------------------


def gnconv3x3_plain(x, a, s, weight, bias, with_silu: bool = True):
    """`_gnconv_kernel` (gn_conv.py:191-270): silu(a·x + s) in fp32 rounded
    to x's dtype (zero outside the image: the conv's padding comes after
    the activation), the conv accumulated in fp32, the fp32 bias, one
    rounding."""
    y = apply_affine_silu(x, a, s, with_silu)
    out = F.conv2d(y.float(), weight.to(x.dtype).float(), None, 1, 1)
    return (out + _bcast(bias.float()[None])).to(x.dtype)


def gnconv3x3(x, a, s, weight, bias, with_silu: bool = True):
    """conv3x3(silu(a·x + s)) + bias -> (B, Cout, H, W). Kernel:
    csrc/conv3x3.cu, `leco_gnconv3x3`. x (B, Cin, H, W) and weight
    (Cout, Cin, 3, 3) bf16; a, s fp32 (B, Cin); bias fp32 (Cout)."""
    if not x.is_cuda:
        return gnconv3x3_plain(x, a, s, weight, bias, with_silu)
    name = "gnconv3x3"
    b, cin, h, w, cout = conv_operands(name, x, weight, bias)
    launch.check(name, "a", a, torch.float32, (b, cin), x.device)
    launch.check(name, "s", s, torch.float32, (b, cin), x.device)
    from leco_tpu_torch.kernels.build import library

    packed = pack_weight(weight)
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    err = library().leco_gnconv3x3(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), packed.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, cin, h, w, cout, int(with_silu),
        launch.stream(x),
    )
    launch.raise_on(name, err)
    gnconv3x3.launches += 1
    return out


KERNEL_WRAPPERS = (gnconv3x3,)
launch.reset(KERNEL_WRAPPERS)


class AffineSiluConv(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through `_conv_reference`
    (gn_conv.py:508-513)."""

    @staticmethod
    def forward(ctx, x, a, s, weight, bias, with_silu):
        ctx.save_for_backward(x, a, s, weight, bias)
        ctx.with_silu = with_silu
        return gnconv3x3(x, a, s, weight, bias, with_silu)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(_conv_reference, ctx, g, ctx.with_silu)


def affine_silu_conv(x, a, s, weight, bias, with_silu: bool = True):
    """conv3x3_s1_p1(silu(a·x + s)) + bias on the kernel. Compute (a, s)
    with `affine_from_gn` so that the gradient of x flows through both the
    data path (this op) and the statistics."""
    return AffineSiluConv.apply(x, a, s, weight, bias, with_silu)
