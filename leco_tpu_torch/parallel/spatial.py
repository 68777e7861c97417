"""Spatial parallelism: the latent H (NCHW dim 2) split over sp.

What GSPMD inserts in the JAX package when `constrain_internal` puts the
latent H on sp, written by hand for the port's layers:

  * a 3x3 conv (`LoRAConv2d`, its LoRA branch too) takes one row of each
    neighbour rank (`halo_rows`; zeros past the global edges, the conv's
    zero padding) and runs without padding in H. The stride-2 downsample's
    output row i reads input rows 2i-1..2i+1, so it takes the row above
    only; the pre-upsample phase conv takes one row of the un-upsampled
    input on either side;
  * GroupNorm's fp32 statistics per (batch, group) are reduced over sp in
    two passes, the mean and then the centred second moment, as
    `F.group_norm` computes them;
  * self-attention takes the JAX package's sequence-parallel rule for the
    flash kernels (`leco_tpu/ops/flash_attention.py:138-180, :362-418`):
    the forward and dQ run on the rank's query rows against K/V gathered
    over sp, and dK/dV run on the rank's K/V rows against the gathered Q,
    dO, lse and Δ. An H-row shard is a contiguous token block, so nothing is
    permuted. The route is chosen on the global token counts, as JAX's
    dispatch sees them under jit. The plain route gathers K/V and
    differentiates through the gather;
  * cross-attention stays local: the rank's queries against the replicated
    text tokens.

The fused-kernel knobs. The JAX package's conv3x3, GroupNorm-SiLU-conv,
GroupNorm, GEGLU and packed-attention `pallas_call`s carry no partitioning
rule: around each, GSPMD all-gathers the sharded operands to replicated,
runs the whole kernel on every device, and slices the output back to the
latent's sharding. So under sp each computes what the unsharded step
computes. The port runs each kernel on the rank's share and computes the
same function:

  * conv3x3 (`LECO_CONV_BACKEND=gemm`): the row-window entry on the rank's
    rows and halo rows (`ops.conv.conv3x3(..., window=True)`);
  * GroupNorm-SiLU-conv (`LECO_RESNET_FUSED=1`): (a, s) from channel sums
    reduced over sp (`affine_from_gn`), then the row-window entry, whose
    halo rows at the image's edge (`edge_rows`) are padding and stay 0
    after the activation (the halo's zeros through silu(a·x + s) would
    become silu(s)); the gate decides on the global H;
  * GroupNorm (`LECO_TPU_FUSED_GN=1`): the kernel's statistics launch, its
    S and SQ summed over sp (`reduce_group_sums`), then its apply launch
    with the global count; the backward differentiates through the sp
    reduction (`group_norm`);
  * the packed forward (`LECO_FLASH_PACKED=1`): the rank's query rows
    against K/V gathered over sp, the plain fp32 backward through the
    gather; GEGLU is row-wise and takes the rank's tokens as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leco_tpu_torch.ops import attention as attn
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops import gn_conv
from leco_tpu_torch.ops import group_norm as gn_ops
from leco_tpu_torch.parallel import collectives as C
from leco_tpu_torch.parallel.mesh import SP_AXIS


def _group(par):
    return par.mesh.group(SP_AXIS)


def halo_rows(x: torch.Tensor, par) -> torch.Tensor:
    """x (B, C, h, W), this rank's rows -> (B, C, h + 2, W) with the row
    above and the row below."""
    return C.halo_rows(x, 2, _group(par))


def edge_rows(par) -> tuple[bool, bool]:
    """Whether the row above and the row below this rank's rows
    (`halo_rows`) are image rows: not past the first or the last rank."""
    group = _group(par)
    rank = C.group_rank(group)
    return rank > 0, rank < C.group_size(group) - 1


def gather_seq(x: torch.Tensor, par) -> torch.Tensor:
    """The ranks' token rows (dim 1) concatenated in rank order."""
    return C.all_gather(x, 1, _group(par))


def conv_input(x: torch.Tensor, par, kernel_size: int, stride: int, padding: int):
    """The rows a 3x3, pad-1 conv of stride 1 or 2 reads for this rank's
    output rows -> (rows, the padding to give F.conv2d)."""
    if (kernel_size, padding) != (3, 1) or stride not in (1, 2):
        raise NotImplementedError(f"spatial parallelism of a {kernel_size}x{kernel_size} "
                                  f"conv with stride {stride} and padding {padding}")
    rows = halo_rows(x, par)
    if stride == 2:  # output row i reads rows 2i-1..2i+1: no row below
        rows = rows[:, :, :-1]
    return rows, (0, padding)


def group_norm(x: torch.Tensor, weight, bias, groups: int, eps: float, silu: bool,
               stat_dtype: torch.dtype, par) -> torch.Tensor:
    """GroupNorm (+ SiLU) over the whole H, from this rank's rows."""
    group = _group(par)
    b, c = x.shape[:2]
    xs = x.to(stat_dtype).reshape(b, groups, -1)
    count = xs.shape[-1] * C.group_size(group)
    mean = C.all_reduce_sum(xs.sum(-1, keepdim=True), group) / count
    centred = xs - mean
    var = C.all_reduce_sum((centred * centred).sum(-1, keepdim=True), group) / count
    y = (centred * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.to(stat_dtype)[None, :, None, None] + bias.to(stat_dtype)[None, :, None, None]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def affine_from_gn(x, weight, bias, temb, groups: int, eps: float, par):
    """`ops.gn_conv.affine_from_gn` over the whole H, from this rank's rows."""
    return gn_conv.affine_from_gn(x, weight, bias, temb, groups, eps, group=_group(par))


def reduce_group_sums(sums: torch.Tensor, count: int, par):
    """Every rank's (B, G, 2) S and SQ summed over sp, and the count of the
    elements they cover."""
    group = _group(par)
    C.sum_tensors([sums], group)
    return sums, count * C.group_size(group)


def fused_group_norm(x: torch.Tensor, weight, bias, groups: int, eps: float, silu: bool,
                     par) -> torch.Tensor:
    """GroupNorm (+ SiLU) over the whole H on the kernel's two launches,
    the statistics summed over sp between them; the backward that of
    `group_norm` in fp32."""
    return gn_ops.split_group_norm(
        x, weight, bias, groups, eps, silu,
        reduce=lambda sums, count: reduce_group_sums(sums, count, par),
        reference=lambda x_, w_, b_: group_norm(x_, w_, b_, groups, eps, silu,
                                                torch.float32, par))


class SequenceParallelFlash(torch.autograd.Function):
    """(BH, Nq/sp, D) queries against (BH, Nk/sp, D) keys and values, each
    rank's rows of one sequence: the flash kernels by the JAX rule."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, par):
        o, lse = fa.attn_fwd(q3, gather_seq(k3, par), gather_seq(v3, par), scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.par = scale, par
        return o

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, o, lse = ctx.saved_tensors
        par, scale = ctx.par, ctx.scale
        g = g.contiguous()
        delta = (g.float() * o.float()).sum(dim=-1)
        dq = fa.attn_bwd_dq(q3, gather_seq(k3, par), gather_seq(v3, par), g, lse, delta, scale)
        dk, dv = fa.attn_bwd_dkv(gather_seq(q3, par), k3, v3, gather_seq(g, par),
                                 gather_seq(lse, par), gather_seq(delta, par), scale)
        return dq, dk, dv, None, None


def attention(q, k, v, num_heads: int, upcast: bool, backend: str, par,
              self_attention: bool) -> torch.Tensor:
    """`ops.attention.multi_head_attention` on this rank's query rows: q
    (B, Nq/sp, C); k, v (B, Nk/sp, C) for self-attention, the whole
    (B, 77, C) text sequence for cross-attention. The route is
    `ops.attention.route`'s on the global token counts."""
    nq = par.global_rows(q.shape[1])
    nk = par.global_rows(k.shape[1]) if self_attention else k.shape[1]
    scale = (q.shape[-1] // num_heads) ** -0.5
    route = attn.route(nq, nk, q, num_heads, backend)
    if route == "packed":
        if self_attention:
            k, v = gather_seq(k, par), gather_seq(v, par)
        return fa.flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                         num_heads, scale)
    if route == "flash":
        q3, k3, v3 = (attn.split_heads(t, num_heads) for t in (q, k, v))
        if self_attention and fa.kernel_backward():
            o3 = SequenceParallelFlash.apply(q3, k3, v3, scale, par)
        else:
            if self_attention:
                k3, v3 = gather_seq(k3, par), gather_seq(v3, par)
            o3 = fa.flash_attention_3d(q3, k3, v3, scale)
        return attn.merge_heads(o3, num_heads)
    if self_attention:
        k, v = gather_seq(k, par), gather_seq(v, par)
    return attn.plain_attention(q, k, v, num_heads, scale, upcast)
