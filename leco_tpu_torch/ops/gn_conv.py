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
`models/unet.py::ResnetBlock2D`; `LECO_GNCONV_KERNEL=0` closes `supports()`.

Under spatial parallelism (`parallel/spatial.py`) a rank's (a, s) come from
channel sums over every rank's rows (`affine_from_gn(..., group=)`), and
the kernel runs on a row window (`gnconv3x3_rows`: the rank's rows and a
halo row of each neighbour) whose first or last row is the zero padding at
the image's edge: `edges` says which are image rows, and a padding row is 0
after the activation, as outside the image in `gnconv3x3`.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from leco_tpu_torch.kernels import launch
from leco_tpu_torch.ops.conv import conv_operands, pack_weight
from leco_tpu_torch.ops.group_norm import group_norm_silu_ref, recompute_grads
from leco_tpu_torch.parallel import collectives as C


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
MIN_FUSED_CHANNELS = 128  # the JAX gate's floor on Cin and Cout


def supports(shape, cout: int, dtype: torch.dtype, device: torch.device) -> bool:
    """The JAX package's hot-shape gate (gn_conv.py:443-455) on an NCHW
    shape, the whole image's (under spatial parallelism the caller gives the
    global H, as the JAX gate sees it under jit): 4 <= h, w <=
    `MAX_FUSED_SIDE` and Cin, Cout >= `MIN_FUSED_CHANNELS` (the caller has
    checked that the conv is 3x3/s1/p1 with a bias). On CUDA the kernel is
    bf16 only. `LECO_GNCONV_KERNEL=0` refuses every shape: the JAX
    package's A/B knob, which sends each fused-resnet conv to the unfused
    route (the GroupNorm, then the conv)."""
    if os.environ.get("LECO_GNCONV_KERNEL", "1") == "0":
        return False
    if len(shape) != 4:
        return False
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        return False
    _, c, h, w = shape
    return (4 <= h <= MAX_FUSED_SIDE and 4 <= w <= MAX_FUSED_SIDE
            and min(c, cout) >= MIN_FUSED_CHANNELS)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def affine_from_gn(x, gn_scale, gn_bias, temb, num_groups: int, eps: float, group=None):
    """Differentiable (a, s), fp32 (B, C), with
    a·x + s == groupnorm(x + temb[:, :, None, None]) * gn_scale + gn_bias.
    `_gn_affine` (gn_conv.py:368-398): sums over (H, W) accumulated in fp32,
    the x·x product in x's dtype, temb folded in through the sums. With a
    process `group` (spatial parallelism), x is this rank's rows and the
    channel sums are summed over the group's ranks before the fold."""
    b, c, h, w = x.shape
    cg = c // num_groups
    hw = h * w * C.group_size(group)
    n = hw * cg
    s1c = x.sum(dim=(2, 3), dtype=torch.float32)
    s2c = (x * x).sum(dim=(2, 3), dtype=torch.float32)
    if C.group_size(group) > 1:
        s1c, s2c = C.all_reduce_sum(torch.stack([s1c, s2c]), group).unbind(0)
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


def _activate(x, a, s, with_silu: bool, edges):
    """The prologue on the whole image (pad 1 in H after it), or on a row
    window (`edges` = (top, bottom): whether its first and last rows are
    image rows; a padding row is 0 after the activation; no pad in H)."""
    y = apply_affine_silu(x, a, s, with_silu)
    if edges is None:
        return y, 1
    keep = torch.ones(x.shape[2], dtype=y.dtype, device=y.device)
    keep[0], keep[-1] = float(edges[0]), float(edges[1])
    return y * keep[:, None], (0, 1)


def _conv_reference(x, a, s, weight, bias, with_silu: bool = True, edges=None):
    """conv3x3(silu(a·x + s)) + bias in plain ops (the backward and the
    tests), everything in x's dtype; `edges` as `_activate`'s."""
    y, pad = _activate(x, a, s, with_silu, edges)
    return F.conv2d(y, weight.to(x.dtype), None, 1, pad) + _bcast(bias.to(x.dtype)[None])


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
    return _gnconv_plain(x, a, s, weight, bias, with_silu, None)


def _gnconv_plain(x, a, s, weight, bias, with_silu, edges):
    y, pad = _activate(x, a, s, with_silu, edges)
    out = F.conv2d(y.float(), weight.to(x.dtype).float(), None, 1, pad)
    return (out + _bcast(bias.float()[None])).to(x.dtype)


def gnconv3x3_rows_plain(x, a, s, weight, bias, with_silu: bool = True,
                         top: bool = True, bottom: bool = True):
    """`gnconv3x3_plain` on a row window: x (B, Cin, h + 2, W) -> (B,
    Cout, h, W), padded in W only; the first (last) row of x is 0 after
    the activation unless `top` (`bottom`) says it is an image row."""
    return _gnconv_plain(x, a, s, weight, bias, with_silu, (top, bottom))


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


def gnconv3x3_rows(x, a, s, weight, bias, with_silu: bool = True,
                   top: bool = True, bottom: bool = True):
    """A row window's conv3x3(silu(a·x + s)) + bias: x (B, Cin, h + 2, W),
    this rank's h rows with a halo row above and below -> (B, Cout, h, W).
    `top` / `bottom`: whether x's first / last row is an image row (else the
    padding past the image's edge, 0 after the activation). Kernel:
    csrc/conv3x3.cu, `leco_gnconv3x3_rows`; operands as `gnconv3x3`'s."""
    if not x.is_cuda:
        return gnconv3x3_rows_plain(x, a, s, weight, bias, with_silu, top, bottom)
    name = "gnconv3x3_rows"
    b, cin, rows, w, cout = conv_operands(name, x, weight, bias)
    if rows < 3:
        raise ValueError(f"{name}: a window of {rows} rows holds no output row")
    launch.check(name, "a", a, torch.float32, (b, cin), x.device)
    launch.check(name, "s", s, torch.float32, (b, cin), x.device)
    from leco_tpu_torch.kernels.build import library

    packed = pack_weight(weight)
    out = torch.empty((b, cout, rows - 2, w), dtype=x.dtype, device=x.device)
    err = library().leco_gnconv3x3_rows(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), packed.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, cin, rows - 2, w, cout, int(with_silu),
        int(top), int(bottom), launch.stream(x),
    )
    launch.raise_on(name, err)
    gnconv3x3_rows.launches += 1
    return out


KERNEL_WRAPPERS = (gnconv3x3, gnconv3x3_rows)
launch.reset(KERNEL_WRAPPERS)


class AffineSiluConv(torch.autograd.Function):
    """Forward: the kernel (on a row window with `edges`). Backward:
    autograd through `_conv_reference` (gn_conv.py:508-513)."""

    @staticmethod
    def forward(ctx, x, a, s, weight, bias, with_silu, edges):
        ctx.save_for_backward(x, a, s, weight, bias)
        ctx.with_silu, ctx.edges = with_silu, edges
        if edges is None:
            return gnconv3x3(x, a, s, weight, bias, with_silu)
        return gnconv3x3_rows(x, a, s, weight, bias, with_silu, *edges)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(_conv_reference, ctx, g, ctx.with_silu, ctx.edges)


def affine_silu_conv(x, a, s, weight, bias, with_silu: bool = True, edges=None):
    """conv3x3_s1_p1(silu(a·x + s)) + bias on the kernel. Compute (a, s)
    with `affine_from_gn` so that the gradient of x flows through both the
    data path (this op) and the statistics. With `edges` = (top, bottom), x
    is a row window (`gnconv3x3_rows`)."""
    return AffineSiluConv.apply(x, a, s, weight, bias, with_silu, edges)
