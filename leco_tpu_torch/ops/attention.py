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
    Returns (B, Nq, C). The rule, as in the JAX package: with
    backend="flash", self-attention with Nq, Nk >= 256 goes to the kernels
    (fp32 on CUDA excepted, see `flash_attention.supports`), to the packed
    one under `LECO_FLASH_PACKED=1` where `supports_packed` admits the
    shape; cross-attention over the 77 text tokens (unless
    `LECO_FLASH_CROSS=1`) and the 64-token mid block take the plain path.
    """
    head_dim = q.shape[-1] // num_heads
    scale = head_dim**-0.5
    if backend not in ("xla", "flash"):
        raise ValueError(f"unknown attention backend: {backend}")

    if (backend == "flash" and fa.packed_enabled()
            and fa.supports(q.shape[1], k.shape[1], q.dtype, q.device)
            and fa.supports_packed(q.shape[1], k.shape[1], q.shape[-1], num_heads)):
        return fa.flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                         num_heads, scale)
    if backend == "flash" and fa.supports(q.shape[1], k.shape[1], q.dtype, q.device):
        q3, k3, v3 = (
            rearrange(t, "b n (h d) -> (b h) n d", h=num_heads).contiguous()
            for t in (q, k, v)
        )
        o3 = fa.flash_attention_3d(q3, k3, v3, scale)
        return rearrange(o3, "(b h) n d -> b n (h d)", h=num_heads)

    qh, kh, vh = (
        rearrange(t, "b n (h d) -> b n h d", h=num_heads) for t in (q, k, v)
    )
    out = _xla_attention(qh, kh, vh, scale, upcast)
    return rearrange(out, "b n h d -> b n (h d)")


def default_backend(device: torch.device | str) -> str:
    """The kernels on CUDA, plain attention elsewhere (CPU tests)."""
    return "flash" if torch.device(device).type == "cuda" else "xla"
