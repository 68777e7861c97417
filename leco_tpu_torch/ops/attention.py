"""Multi-head dot-product attention with two backends.

Counterpart of `leco_tpu/ops/attention.py`:

  * backend="xla": plain attention in PyTorch (the JAX package's
    `_xla_attention`, which it leaves to XLA), with the optional fp32
    softmax upcast (SD2.1's `upcast_attention`).
  * backend="flash": the flash-attention kernels of
    `leco_tpu_torch.ops.flash_attention` for the shapes `supports()` admits;
    every other shape takes the plain attention. Under `LECO_FLASH_PACKED=1`
    (read at call time) the shapes `supports_packed()` admits take the
    packed-layout kernel instead, with no head transposes; under
    `LECO_FLASH_CROSS=1` cross-attention with Nq >= 256 takes the 3-d
    kernels too, and `LECO_FLASH_BWD` other than "pallas" gives the 3-d
    route the plain fp32 backward (`flash_attention.kernel_backward`).

The fp32 softmax upcast (`upcast`) applies on the plain path only; the
kernels keep their own fp32 softmax, as in the JAX package.
"""

from __future__ import annotations

import torch
from einops import rearrange

from leco_tpu_torch.ops import flash_attention as fa


def _xla_attention(q, k, v, scale: float, upcast: bool):
    """q: (B, Nq, H, D); k, v: (B, Nk, H, D) -> (B, Nq, H, D)."""
    dtype = q.dtype
    if upcast:
        q = q.float()
        k = k.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def route(nq: int, nk: int, q: torch.Tensor, num_heads: int, backend: str) -> str:
    """The route of Nq queries against Nk keys: "packed", "flash" (the 3-d
    kernels) or "plain". The rule, as in the JAX package: with
    backend="flash", self-attention with Nq, Nk >= 256 goes to the kernels
    (fp32 on CUDA excepted, see `flash_attention.supports`), to the packed
    one under `LECO_FLASH_PACKED=1` where `supports_packed` admits the
    shape; cross-attention over the 77 text tokens (unless
    `LECO_FLASH_CROSS=1`) and the 64-token mid block take the plain path.
    """
    if backend not in ("xla", "flash"):
        raise ValueError(f"unknown attention backend: {backend}")
    if backend == "flash" and fa.supports(nq, nk, q.dtype, q.device):
        if fa.packed_enabled() and fa.supports_packed(nq, nk, q.shape[-1], num_heads):
            return "packed"
        return "flash"
    return "plain"


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B*H, N, D), the 3-d kernels' layout."""
    return rearrange(t, "b n (h d) -> (b h) n d", h=num_heads).contiguous()


def merge_heads(o3: torch.Tensor, num_heads: int) -> torch.Tensor:
    return rearrange(o3, "(b h) n d -> b n (h d)", h=num_heads)


def plain_attention(q, k, v, num_heads: int, scale: float, upcast: bool) -> torch.Tensor:
    """`_xla_attention` on (B, N, H*D) sequences."""
    qh, kh, vh = (rearrange(t, "b n (h d) -> b n h d", h=num_heads) for t in (q, k, v))
    return rearrange(_xla_attention(qh, kh, vh, scale, upcast), "b n h d -> b n (h d)")


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    upcast: bool = False,
    backend: str = "xla",
) -> torch.Tensor:
    """Attention over flattened token sequences.

    q: (B, Nq, C); k, v: (B, Nk, C) with C = num_heads * head_dim.
    Returns (B, Nq, C), by the route `route` gives.
    """
    scale = (q.shape[-1] // num_heads) ** -0.5
    chosen = route(q.shape[1], k.shape[1], q, num_heads, backend)
    if chosen == "packed":
        return fa.flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                         num_heads, scale)
    if chosen == "flash":
        q3, k3, v3 = (split_heads(t, num_heads) for t in (q, k, v))
        return merge_heads(fa.flash_attention_3d(q3, k3, v3, scale), num_heads)
    return plain_attention(q, k, v, num_heads, scale, upcast)


def default_backend(device: torch.device | str) -> str:
    """The kernels on CUDA, plain attention elsewhere (CPU tests)."""
    return "flash" if torch.device(device).type == "cuda" else "xla"
