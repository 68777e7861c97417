"""GroupNorm (+ optional SiLU) with fp32 statistics: the Hopper kernel, its
plain version, the reference form and the autograd Function.

Counterpart of `leco_tpu/ops/group_norm.py`. The TPU kernel `_gn_kernel`
becomes `leco_tpu_torch/kernels/csrc/group_norm.cu`, written in CUDA rather
than Triton: it splits each (batch, group) over a thread-block cluster whose
blocks keep their share of x in shared memory (so x is read once) and
combine their partial sums through distributed shared memory, and Triton
has neither clusters nor distributed shared memory.

Layout is the port's NCHW, x (B, C, H, W); the JAX package takes NHWC. The
knob `LECO_TPU_FUSED_GN=1` (read at call time; the JAX package reads it at
import) sends the UNet's GroupNorms through `fused_group_norm`: the kernel
for bf16 CUDA tensors, its plain version for CPU tensors.

Under spatial parallelism a rank holds some rows of every group, so the
statistics must cover every rank's rows: the kernel then runs as two
launches, `group_norm_stats` (each (batch, group)'s fp32 S and SQ) and
`group_norm_apply` (the normalisation with S and SQ over a count given
with them), and `split_group_norm` reduces the statistics in between.
"""

from __future__ import annotations

import os

import torch

from leco_tpu_torch.kernels import launch


def fused_enabled() -> bool:
    return os.environ.get("LECO_TPU_FUSED_GN", "0") == "1"


def supports(dtype: torch.dtype, device: torch.device) -> bool:
    """May `fused_group_norm` take this input? On CUDA the kernel is bf16
    only (fp32 keeps the default GroupNorm); on the CPU every dtype runs the
    kernel's plain version."""
    return torch.device(device).type != "cuda" or dtype == torch.bfloat16


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def _sums(x, num_groups: int) -> torch.Tensor:
    """fp32 per-channel sums of x and x², then group sums -> (B, G, 2)."""
    b, c = x.shape[:2]
    xf = x.float()
    s = xf.sum(dim=(2, 3))
    sq = (xf * xf).sum(dim=(2, 3))
    return torch.stack([s.reshape(b, num_groups, -1).sum(-1),
                        sq.reshape(b, num_groups, -1).sum(-1)], dim=-1)


def _normalise(x, scale, bias, sums, count, eps: float, with_silu: bool):
    """mean = S/n, var = SQ/n − μ² (no clamp), rsqrt(var + eps), the
    per-channel scale/shift fold, optional SiLU, one rounding."""
    cg = x.shape[1] // sums.shape[1]
    mean_g = sums[..., 0] / count
    var_g = sums[..., 1] / count - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cg, dim=1)
    inv_c = inv_g.repeat_interleave(cg, dim=1)
    sc = scale.float()[None, :] * inv_c
    sh = bias.float()[None, :] - mean_c * sc
    y = x.float() * _bcast(sc) + _bcast(sh)
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_plain(x, scale, bias, num_groups: int, eps: float,
                          with_silu: bool = True):
    """`_gn_kernel` (group_norm.py:26-73) step for step: fp32 per-channel
    sums of x and x², group sums, var = E[x²] − μ² (no clamp),
    rsqrt(var + eps), the per-channel scale/shift fold, optional SiLU, one
    rounding to x's dtype."""
    n = x.shape[1] // num_groups * x.shape[2] * x.shape[3]
    return _normalise(x, scale, bias, _sums(x, num_groups), n, eps, with_silu)


def group_norm_stats_plain(x, num_groups: int) -> torch.Tensor:
    """The first half of `group_norm_silu_plain`: each (batch, group)'s
    fp32 S and SQ -> (B, G, 2)."""
    return _sums(x, num_groups)


def group_norm_apply_plain(x, scale, bias, sums, count: int, eps: float,
                           with_silu: bool = True):
    """The second half: x normalised with `sums` (B, G, 2) fp32 as the
    S and SQ of `count` elements a group."""
    return _normalise(x, scale, bias, sums, count, eps, with_silu)


def group_norm_silu_ref(x, scale, bias, num_groups: int, eps: float,
                        with_silu: bool = True):
    """The two-pass reference (group_norm.py:130-141): centred variance."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _check_x(name, x, num_groups: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {x.dtype} is not the kernel's bfloat16")
    if x.ndim != 4 or x.shape[1] % num_groups:
        raise ValueError(f"{name}: shape {tuple(x.shape)} is not (B, C, H, W) "
                         f"with C a multiple of {num_groups} groups")
    launch.check(name, "x", x, torch.bfloat16, tuple(x.shape), x.device)


def group_norm_silu(x, scale, bias, num_groups: int, eps: float,
                    with_silu: bool = True):
    """GroupNorm(+SiLU) -> x's shape and dtype. Kernel: csrc/group_norm.cu;
    scale and bias go to it in fp32."""
    if not x.is_cuda:
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, with_silu)
    name = "group_norm_silu"
    _check_x(name, x, num_groups)
    b, c, h, w = x.shape
    dev = x.device
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    launch.check(name, "scale", scale, torch.float32, (c,), dev)
    launch.check(name, "bias", bias, torch.float32, (c,), dev)
    from leco_tpu_torch.kernels.build import library

    y = torch.empty_like(x)
    err = library().leco_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c,
        h * w, num_groups, float(eps), int(with_silu), launch.stream(x),
    )
    launch.raise_on(name, err)
    group_norm_silu.launches += 1
    return y


def group_norm_stats(x, num_groups: int) -> torch.Tensor:
    """Each (batch, group)'s S and SQ -> (B, G, 2) fp32. Kernel:
    csrc/group_norm.cu, `leco_group_norm_stats`."""
    if not x.is_cuda:
        return group_norm_stats_plain(x, num_groups)
    name = "group_norm_stats"
    _check_x(name, x, num_groups)
    b, c, h, w = x.shape
    from leco_tpu_torch.kernels.build import library

    sums = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    err = library().leco_group_norm_stats(x.data_ptr(), sums.data_ptr(), b, c, h * w,
                                          num_groups, launch.stream(x))
    launch.raise_on(name, err)
    group_norm_stats.launches += 1
    return sums


def group_norm_apply(x, scale, bias, sums, count: int, eps: float, with_silu: bool = True):
    """x normalised (+SiLU) with `sums` (B, G, 2) fp32, the S and SQ of
    `count` elements a group -> x's shape and dtype. Kernel:
    csrc/group_norm.cu, `leco_group_norm_apply`."""
    if not x.is_cuda:
        return group_norm_apply_plain(x, scale, bias, sums, count, eps, with_silu)
    name = "group_norm_apply"
    num_groups = sums.shape[1]
    _check_x(name, x, num_groups)
    b, c, h, w = x.shape
    dev = x.device
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    launch.check(name, "scale", scale, torch.float32, (c,), dev)
    launch.check(name, "bias", bias, torch.float32, (c,), dev)
    launch.check(name, "sums", sums, torch.float32, (b, num_groups, 2), dev)
    from leco_tpu_torch.kernels.build import library

    y = torch.empty_like(x)
    err = library().leco_group_norm_apply(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), sums.data_ptr(), y.data_ptr(), b, c,
        h * w, num_groups, float(count), float(eps), int(with_silu), launch.stream(x),
    )
    launch.raise_on(name, err)
    group_norm_apply.launches += 1
    return y


KERNEL_WRAPPERS = (group_norm_silu, group_norm_stats, group_norm_apply)
launch.reset(KERNEL_WRAPPERS)


class FusedGroupNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through `group_norm_silu_ref`,
    as `_fgn_bwd` (group_norm.py:255-268) does."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, with_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, with_silu)
        return group_norm_silu(x, scale, bias, num_groups, eps, with_silu)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(group_norm_silu_ref, ctx, g, *ctx.args)


def recompute_grads(fn, ctx, g, *static):
    """The gradient of `fn(*saved, *static)` for the saved tensors that need
    one (None for the rest and for the static arguments)."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(saved, needs)]
        out = fn(*inputs, *static)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return (*(next(grads) if need else None for need in needs), *(None,) * len(static))


def fused_group_norm(x, scale, bias, num_groups: int, eps: float, with_silu: bool):
    return FusedGroupNorm.apply(x, scale, bias, num_groups, eps, with_silu)


class SplitGroupNorm(torch.autograd.Function):
    """Forward: the statistics launch, `reduce(sums, count)` -> (sums,
    count) (the sum over the ranks that share the groups), the apply
    launch. Backward: autograd through `reference(x, scale, bias)`, the
    same GroupNorm in differentiable plain ops with its statistics reduced
    alike."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, with_silu, reduce, reference):
        ctx.save_for_backward(x, scale, bias)
        ctx.reference = reference
        count = x.shape[1] // num_groups * x.shape[2] * x.shape[3]
        sums, count = reduce(group_norm_stats(x, num_groups), count)
        return group_norm_apply(x, scale, bias, sums, count, eps, with_silu)

    @staticmethod
    def backward(ctx, g):
        return (*recompute_grads(ctx.reference, ctx, g), *(None,) * 5)


def split_group_norm(x, scale, bias, num_groups: int, eps: float, with_silu: bool,
                     reduce, reference):
    """GroupNorm(+SiLU) on the kernel's two launches, the statistics
    reduced by `reduce` in between (`SplitGroupNorm`)."""
    return SplitGroupNorm.apply(x, scale, bias, num_groups, eps, with_silu, reduce, reference)

