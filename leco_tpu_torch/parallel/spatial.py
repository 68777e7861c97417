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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leco_tpu_torch.ops import attention as attn
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.parallel import collectives as C
from leco_tpu_torch.parallel.mesh import SP_AXIS


def _group(par):
    return par.mesh.group(SP_AXIS)


def halo_rows(x: torch.Tensor, par) -> torch.Tensor:
    """x (B, C, h, W), this rank's rows -> (B, C, h + 2, W) with the row
    above and the row below."""
    return C.halo_rows(x, 2, _group(par))


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
    `ops.attention.route`'s on the global token counts ("packed" does not
    arise: the parallel context refuses `LECO_FLASH_PACKED`)."""
    n = C.group_size(_group(par))
    nq = q.shape[1] * n
    nk = k.shape[1] * n if self_attention else k.shape[1]
    scale = (q.shape[-1] // num_heads) ** -0.5
    if attn.route(nq, nk, q, num_heads, backend) != "plain":
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
