"""Autograd-aware collectives over one process group.

What GSPMD inserts in the JAX package, written by hand: each is an autograd
Function whose backward is the forward's adjoint when every rank's own
objective counts (the sharded step's loss is the sum of the ranks' local
sums). A group of None (an axis of size 1) makes each one the identity.

  * `all_gather(x, dim)`: the ranks' tensors concatenated along `dim`; the
    backward hands back this rank's slice of the gradient summed over the
    ranks.
  * `all_reduce_sum(x)`: the sum over the ranks; the backward all-reduces
    the gradient.
  * `copy_to_group(x)`, Megatron's f: the identity, the backward
    all-reduces the gradient (the input of a column-parallel layer).
  * `reduce_from_group(x)`, Megatron's g: the sum over the ranks, the
    backward the identity (the output of a row-parallel layer).
  * `halo_rows(x, dim)`: x with one row of each neighbour rank on either
    side of `dim` (zeros past the global edges, the zero padding); the
    backward adds the halo rows' gradients back to the rows they came from.

The gathers are `all_gather_into_tensor` and the gathers' backward a
`reduce_scatter_tensor`, which NCCL takes and gloo takes too, for CUDA
tensors as for CPU ones (chip_smoke phase parallel's ranks run both
over gloo on the card); the sums are `all_reduce`. Nothing is staged through the host here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x stacked in rank order -> (n, *x.shape)."""
    x = x.contiguous()
    n = group_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))  # gloo wants the dim-0 concatenation
    dist.all_gather_into_tensor(out, x, group=group)
    return out.unflatten(0, (n, x.shape[0]))


def _cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order."""
    return _gather(x, group).movedim(0, dim).flatten(dim, dim + 1)


def _sum_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along `dim` of g summed over the ranks."""
    n = group_size(group)
    chunks = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = chunks.new_empty(chunks.shape[1:])
    dist.reduce_scatter_tensor(out, chunks.flatten(0, 1), group=group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return _cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _edges(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The first and the last row of `dim`, stacked along `dim`."""
    return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        n, r = group_size(group), group_rank(group)
        parts = _gather(_edges(x, dim), group)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        top = parts[r - 1].narrow(dim, 1, 1) if r > 0 else zero
        bottom = parts[r + 1].narrow(dim, 0, 1) if r < n - 1 else zero
        return torch.cat([top, x, bottom], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.dim, ctx.group
        n, r = group_size(group), group_rank(group)
        h = g.shape[dim] - 2
        dx = g.narrow(dim, 1, h).clone()
        parts = _gather(_edges(g, dim), group)  # each rank's (top, bottom) halo gradient
        if r > 0:  # this rank's first row was the rank above's bottom halo
            dx.narrow(dim, 0, 1).add_(parts[r - 1].narrow(dim, 1, 1))
        if r < n - 1:  # and its last row the rank below's top halo
            dx.narrow(dim, h - 1, 1).add_(parts[r + 1].narrow(dim, 0, 1))
        return dx, None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def halo_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group_size(group) == 1:
        pad = [0, 0] * (x.ndim - 1 - dim) + [1, 1]
        return F.pad(x, pad)
    return _HaloRows.apply(x, dim, group)


def sum_tensors(tensors: list[torch.Tensor], group) -> None:
    """All-reduce (sum) a list of tensors in place, as one flat buffer."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
