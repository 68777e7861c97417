"""Flash attention: the four Hopper kernels, their plain versions, and the
autograd Functions that join them.

Counterpart of `leco_tpu/ops/flash_attention.py`. The TPU kernels
(`_attn_kernel`, `_attn_bwd_dq_kernel`, `_attn_bwd_dkv_kernel`,
`_attn_kernel_packed`) become CUDA kernels in `leco_tpu_torch/kernels/csrc/`
(flash_fwd.cu with two entry points, flash_bwd_dq.cu, flash_bwd_dkv.cu),
built by `kernels/build.py` and called through ctypes.

Each kernel has a wrapper and a plain PyTorch version with the same
signature. The wrapper launches the kernel for a CUDA tensor (and raises on
anything the kernel does not take) and runs the plain version only for a CPU
tensor. Each wrapper counts its launches in `<wrapper>.launches`.

Layouts, as in the JAX package: q3 (BH, Nq, D); k3, v3 (BH, Nk, D); the
log-sum-exp residual lse and delta = rowsum(dO * O) are fp32 (BH, Nq). The
packed route (`LECO_FLASH_PACKED=1`) keeps the model's layout: q2 (B, Nq, C),
k2, v2 (B, Nk, C) with C = heads * D, and no lse; its backward is plain fp32
PyTorch, as the JAX package's is XLA einsum. `LECO_FLASH_BWD` other than
"pallas" gives the 3-d route that plain fp32 backward too, and
`LECO_FLASH_CROSS=1` sends cross-attention to the forward kernel.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from einops import rearrange

from leco_tpu_torch.kernels import launch

KERNEL_HEAD_DIMS = (40, 64, 80, 160)
KERNEL_DTYPES = (torch.bfloat16,)


def supports(nq: int, nk: int, dtype: torch.dtype, device: torch.device) -> bool:
    """The dispatch rule of `ops/attention.py`. Shapes, as in the JAX
    package (`supports`, :659-670): self-attention at the top UNet levels
    only (Nq, Nk >= 256); cross-attention over 77 tokens and the 64-token
    mid block take the plain attention, except that `LECO_FLASH_CROSS=1`
    (read at call time) admits any Nk once Nq >= 256. Dtype: an fp32 tensor
    on CUDA takes the plain attention too, since the kernels are bf16; on
    the CPU every dtype goes through the kernels' plain versions."""
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        return False
    if os.environ.get("LECO_FLASH_CROSS") == "1":
        return nq >= 256
    return nq >= 256 and nk >= 256


def kernel_backward() -> bool:
    """`LECO_FLASH_BWD` (read at call time, default "pallas", the JAX
    package's knob at :464): any other value sends the 3-d route's backward
    to `attn_bwd_plain`, the fp32 backward from the whole softmax, as the JAX
    package falls back to XLA."""
    return os.environ.get("LECO_FLASH_BWD", "pallas") == "pallas"


PACKED_KV_ALIGN = 128


def supports_packed(nq: int, nk: int, c: int, heads: int) -> bool:
    """The JAX package's `supports_packed` (:650-656) without its VMEM
    arithmetic, a TPU limit (the port keeps the JAX package's shape gates
    only, as `supports` does): self-attention with Nq, Nk >= 256 and whole
    heads."""
    return c % heads == 0 and nq >= 256 and nk >= 256


def packed_enabled() -> bool:
    """`LECO_FLASH_PACKED=1`, read at call time (the JAX package's knob)."""
    return os.environ.get("LECO_FLASH_PACKED") == "1"


def _check_cuda(name: str, tensors: dict, shapes: dict) -> None:
    """Every kernel reads q, k, v (and dO) and writes its outputs through TMA
    tensor maps, which need 16-byte starts."""
    dtype = tensors["q3"].dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {dtype} is not a kernel dtype {KERNEL_DTYPES}")
    for key, t in tensors.items():
        want_dtype = torch.float32 if key in ("lse", "delta") else dtype
        launch.check(name, key, t, want_dtype, shapes[key], tensors["q3"].device,
                     aligned=True)
    d = tensors["q3"].shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one of {KERNEL_HEAD_DIMS}")


def _shapes(q3, k3):
    bh, nq, d = q3.shape
    nk = k3.shape[1]
    return bh, nq, nk, d, {
        "q3": (bh, nq, d), "k3": (bh, nk, d), "v3": (bh, nk, d),
        "g": (bh, nq, d), "lse": (bh, nq), "delta": (bh, nq),
    }


# ---------------------------------------------------------------------------
# plain versions: the Pallas kernel bodies, line for line, over the whole K/V
# ---------------------------------------------------------------------------


def _scaled_q(q3: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is folded into q with a rounding to q's dtype (TPU kernel :78)
    return (q3.float() * scale).to(q3.dtype)


def attn_fwd_plain(q3, k3, v3, scale: float):
    """-> (o (BH, Nq, D) in q's dtype, lse (BH, Nq) fp32). `_attn_kernel`."""
    qs = _scaled_q(q3, scale)
    logits = torch.einsum("bqd,bkd->bqk", qs.float(), k3.float())
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(v3.dtype).float(), v3.float())
    o = (out / denom).to(q3.dtype)
    lse = (m + torch.log(denom)).squeeze(-1)
    return o, lse


def attn_fwd_packed_plain(q2, k2, v2, heads: int, scale: float):
    """-> o (B, Nq, C) in q's dtype. `_attn_kernel_packed` (:528-556): per
    head, the scale folded into the rounded (rows, D) q slice; K/V padded to
    a multiple of 128 and the padding masked at -1e30; P rounded to V's
    dtype before P·V; the output times 1/denom; no lse."""
    b, nq, c = q2.shape
    nk = k2.shape[1]
    d = c // heads
    nk_pad = -(-nk // PACKED_KV_ALIGN) * PACKED_KV_ALIGN
    k2 = F.pad(k2, (0, 0, 0, nk_pad - nk))
    v2 = F.pad(v2, (0, 0, 0, nk_pad - nk))
    masked = torch.arange(nk_pad, device=q2.device) >= nk
    outs = []
    for h in range(heads):
        sl = slice(h * d, (h + 1) * d)
        qh = _scaled_q(q2[..., sl], scale)
        logits = torch.einsum("bqd,bkd->bqk", qh.float(), k2[..., sl].float())
        logits = logits.masked_fill(masked, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        denom = p.sum(dim=-1, keepdim=True)
        oh = torch.einsum("bqk,bkd->bqd", p.to(v2.dtype).float(), v2[..., sl].float())
        outs.append(oh * (1.0 / denom))
    return torch.cat(outs, dim=-1).to(q2.dtype)


def attn_bwd_packed_plain(q2, k2, v2, g, heads: int, scale: float):
    """(dq, dk, dv) of packed attention in fp32, the JAX package's
    `_packed_bwd` (:622-644), which is XLA einsum there, not a kernel. It
    holds several (B, heads, Nq, Nk) fp32 tensors at once."""
    b, nq, c = q2.shape
    d = c // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, d).float()

    q, k, v, g4 = split(q2), split(k2), split(v2), split(g)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(logits, dim=-1)
    del logits
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g4)
    dp = torch.einsum("bqhd,bkhd->bhqk", g4, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return (dq.reshape(b, nq, c).to(q2.dtype), dk.reshape(k2.shape).to(k2.dtype),
            dv.reshape(v2.shape).to(v2.dtype))


def attn_bwd_plain(q3, k3, v3, g, scale: float):
    """(dq, dk, dv) of 3-d attention in fp32 from the whole softmax: the
    JAX package's XLA backward (:470-483), `attn_bwd_packed_plain` with one
    head."""
    return attn_bwd_packed_plain(q3, k3, v3, g, 1, scale)


def attn_bwd_dq_plain(q3, k3, v3, g, lse, delta, scale: float):
    """dQ = (P∘(dO·Vᵀ − Δ))·K·scale. `_attn_bwd_dq_kernel`."""
    qs = _scaled_q(q3, scale)
    logits = torch.einsum("bqd,bkd->bqk", qs.float(), k3.float())
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v3.float())
    ds = (p * (dp - delta[..., None])).to(k3.dtype)
    dq = torch.einsum("bqk,bkd->bqd", ds.float(), k3.float())
    return (dq * scale).to(q3.dtype)


def attn_bwd_dkv_plain(q3, k3, v3, g, lse, delta, scale: float):
    """dV = Pᵀ·dO, dK = (Pᵀ∘(V·dOᵀ − Δ))·qs. `_attn_bwd_dkv_kernel`."""
    qs = _scaled_q(q3, scale)
    logits_t = torch.einsum("bkd,bqd->bkq", k3.float(), qs.float())
    p_t = torch.exp(logits_t - lse[:, None, :])
    dv = torch.einsum("bkq,bqd->bkd", p_t.to(g.dtype).float(), g.float())
    dp_t = torch.einsum("bkd,bqd->bkq", v3.float(), g.float())
    ds_t = (p_t * (dp_t - delta[:, None, :])).to(qs.dtype)
    dk = torch.einsum("bkq,bqd->bkd", ds_t.float(), qs.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def attn_fwd(q3, k3, v3, scale: float):
    """Flash forward -> (o, lse). Kernel: csrc/flash_fwd.cu."""
    if not q3.is_cuda:
        return attn_fwd_plain(q3, k3, v3, scale)
    bh, nq, nk, d, shapes = _shapes(q3, k3)
    _check_cuda("attn_fwd", {"q3": q3, "k3": k3, "v3": v3}, shapes)
    from leco_tpu_torch.kernels.build import library

    o = torch.empty_like(q3)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q3.device)
    err = library().leco_flash_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, nq, nk, d, float(scale), launch.stream(q3),
    )
    launch.raise_on("attn_fwd", err)
    attn_fwd.launches += 1
    return o, lse


def attn_bwd_dq(q3, k3, v3, g, lse, delta, scale: float):
    """Flash backward dQ. Kernel: csrc/flash_bwd_dq.cu."""
    if not q3.is_cuda:
        return attn_bwd_dq_plain(q3, k3, v3, g, lse, delta, scale)
    bh, nq, nk, d, shapes = _shapes(q3, k3)
    _check_cuda(
        "attn_bwd_dq",
        {"q3": q3, "k3": k3, "v3": v3, "g": g, "lse": lse, "delta": delta},
        shapes,
    )
    from leco_tpu_torch.kernels.build import library

    dq = torch.empty_like(q3)
    err = library().leco_flash_bwd_dq(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, nq, nk, d,
        float(scale), launch.stream(q3),
    )
    launch.raise_on("attn_bwd_dq", err)
    attn_bwd_dq.launches += 1
    return dq


def attn_bwd_dkv(q3, k3, v3, g, lse, delta, scale: float):
    """Flash backward (dK, dV). Kernel: csrc/flash_bwd_dkv.cu."""
    if not q3.is_cuda:
        return attn_bwd_dkv_plain(q3, k3, v3, g, lse, delta, scale)
    bh, nq, nk, d, shapes = _shapes(q3, k3)
    _check_cuda(
        "attn_bwd_dkv",
        {"q3": q3, "k3": k3, "v3": v3, "g": g, "lse": lse, "delta": delta},
        shapes,
    )
    from leco_tpu_torch.kernels.build import library

    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    err = library().leco_flash_bwd_dkv(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, nq, nk, d, float(scale), launch.stream(q3),
    )
    launch.raise_on("attn_bwd_dkv", err)
    attn_bwd_dkv.launches += 1
    return dk, dv


def attn_fwd_packed(q2, k2, v2, heads: int, scale: float):
    """Packed flash forward -> o (B, Nq, C). Kernel: csrc/flash_fwd.cu,
    entry point `leco_flash_fwd_packed`."""
    if not q2.is_cuda:
        return attn_fwd_packed_plain(q2, k2, v2, heads, scale)
    b, nq, c = q2.shape
    nk = k2.shape[1]
    if q2.dtype not in KERNEL_DTYPES:
        raise TypeError(f"attn_fwd_packed: dtype {q2.dtype} is not a kernel dtype {KERNEL_DTYPES}")
    if c % heads or c // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attn_fwd_packed: C {c} over {heads} heads is not a head dim "
                         f"of {KERNEL_HEAD_DIMS}")
    for key, t, shape in (("q2", q2, (b, nq, c)), ("k2", k2, (b, nk, c)),
                          ("v2", v2, (b, nk, c))):
        launch.check("attn_fwd_packed", key, t, q2.dtype, shape, q2.device, aligned=True)
    from leco_tpu_torch.kernels.build import library

    o = torch.empty_like(q2)
    err = library().leco_flash_fwd_packed(
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), o.data_ptr(),
        b, heads, nq, nk, c, float(scale), launch.stream(q2),
    )
    launch.raise_on("attn_fwd_packed", err)
    attn_fwd_packed.launches += 1
    return o


KERNEL_WRAPPERS = (attn_fwd, attn_bwd_dq, attn_bwd_dkv, attn_fwd_packed)
launch.reset(KERNEL_WRAPPERS)


def reset_launch_counts() -> None:
    launch.reset(KERNEL_WRAPPERS)


def launch_counts() -> dict[str, int]:
    return launch.counts(KERNEL_WRAPPERS)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FlashAttention3D(torch.autograd.Function):
    """(BH, Nq, D) attention whose forward and backward are the wrappers
    above (the JAX package's `_flash_3d` custom VJP)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float):
        o, lse = attn_fwd(q3, k3, v3, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, o, lse = ctx.saved_tensors
        g = g.contiguous()
        if not kernel_backward():
            return (*attn_bwd_plain(q3, k3, v3, g, ctx.scale), None)
        # Δ = rowsum(dO ∘ O), an fp32 reduction outside the kernels (:465-468)
        delta = (g.float() * o.float()).sum(dim=-1)
        dq = attn_bwd_dq(q3, k3, v3, g, lse, delta, ctx.scale)
        dk, dv = attn_bwd_dkv(q3, k3, v3, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention_3d(q3, k3, v3, scale: float) -> torch.Tensor:
    return FlashAttention3D.apply(q3, k3, v3, scale)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, Nq, H, D); k, v: (B, Nk, H, D) -> (B, Nq, H, D)."""
    b, _, h, _ = q.shape
    q3, k3, v3 = (
        rearrange(t, "b n h d -> (b h) n d").contiguous() for t in (q, k, v)
    )
    o3 = flash_attention_3d(q3, k3, v3, scale)
    return rearrange(o3, "(b h) n d -> b n h d", b=b, h=h)


class FlashAttentionPacked(torch.autograd.Function):
    """(B, N, C) attention: the packed forward wrapper and the plain fp32
    backward (the JAX package's `flash_attention_packed` custom VJP)."""

    @staticmethod
    def forward(ctx, q2, k2, v2, heads: int, scale: float):
        ctx.save_for_backward(q2, k2, v2)
        ctx.heads, ctx.scale = heads, scale
        return attn_fwd_packed(q2, k2, v2, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2 = ctx.saved_tensors
        dq, dk, dv = attn_bwd_packed_plain(q2, k2, v2, g, ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_packed(q2, k2, v2, heads: int, scale: float) -> torch.Tensor:
    """q2: (B, Nq, heads*D); k2, v2: (B, Nk, heads*D) -> (B, Nq, heads*D)."""
    return FlashAttentionPacked.apply(q2, k2, v2, heads, scale)
