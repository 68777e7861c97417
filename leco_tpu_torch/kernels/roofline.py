"""The least time an NVIDIA H100 (SXM, 700 W) could take for the work of
each of the port's kernels: the roofline bound that `chip_smoke.py` sets
beside each kernel's measured time.

A bound is the larger of two times: the operations the function must do
over the card's peak rate for their type, and the bytes it must move (each
input read once, each output written once) over the memory rate. The
operations are counted from the shapes alone; nothing here runs a kernel.
Exponentials (the flash forward's Nq·Nk of them, on the special-function
units) are not in these counts: the published table has no rate for them.
"""

from __future__ import annotations

BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
BYTES_PER_S = 3.35e12  # HBM3
BF16, FP32 = 2, 4  # bytes per element
SD_GROUPS = 32  # the UNet's GroupNorm groups: the split GroupNorm's (B, 32, 2) sums


def bound_ms(ops: float, nbytes: float, peak: float = BF16_TENSOR_FLOPS) -> float:
    """max(ops / peak, bytes / memory rate), in milliseconds."""
    return max(ops / peak, nbytes / BYTES_PER_S) * 1e3


def bound_by(ops: float, nbytes: float, peak: float = BF16_TENSOR_FLOPS) -> str:
    return "operations" if ops / peak >= nbytes / BYTES_PER_S else "bytes"


def _attention(bh, nq, nk, d, products, q_like, k_like, rows_fp32):
    """`products` (Nq x Nk x D) matrix products; `q_like` and `k_like`
    (rows, D) bf16 tensors of Nq and Nk rows; `rows_fp32` (BH, Nq) fp32
    vectors."""
    ops = 2 * products * bh * nq * nk * d
    nbytes = bh * d * BF16 * (q_like * nq + k_like * nk) + rows_fp32 * bh * nq * FP32
    return ops, nbytes


def work(name: str, shape: tuple) -> tuple[float, float, float]:
    """(operations, bytes, peak rate of those operations) of one call of the
    kernel `name` at `shape`, in the shape convention of chip_smoke.py."""
    if name == "attn_fwd":  # (BH, Nq, Nk, D): S = Q·Kᵀ, O = P·V; in q, k, v; out o, lse
        return (*_attention(*shape, products=2, q_like=2, k_like=2, rows_fp32=1),
                BF16_TENSOR_FLOPS)
    if name == "attn_bwd_dq":  # S again, dP = dO·Vᵀ, dQ = dS·K; in q, dO, lse, Δ, k, v; out dq
        return (*_attention(*shape, products=3, q_like=3, k_like=2, rows_fp32=2),
                BF16_TENSOR_FLOPS)
    if name == "attn_bwd_dkv":  # S again, dV = Pᵀ·dO, dPᵀ, dK = dSᵀ·q; out dk, dv
        return (*_attention(*shape, products=4, q_like=2, k_like=4, rows_fp32=2),
                BF16_TENSOR_FLOPS)
    if name == "attn_fwd_packed":  # (B, Nq, Nk, C, heads): the forward over C = heads·D, no lse
        b, nq, nk, c, _heads = shape
        return (*_attention(b, nq, nk, c, products=2, q_like=2, k_like=2, rows_fp32=0),
                BF16_TENSOR_FLOPS)
    if name in ("conv3x3", "gnconv3x3", "conv3x3_rows", "gnconv3x3_rows"):
        # (B, Cin, H, W, Cout): 9 taps; x, w, fp32 bias -> y. A row window
        # (H = h, the output's rows) reads h + 2 input rows
        b, cin, h, w, cout = shape[:5]
        rows_in = h + 2 if name.endswith("_rows") else h
        ops = 2 * b * h * w * 9 * cin * cout
        nbytes = (b * cin * rows_in * w + 9 * cin * cout + b * cout * h * w) * BF16 + cout * FP32
        if name.startswith("gnconv3x3"):  # the per-(batch, channel) fp32 affine (a, s)
            nbytes += 2 * b * cin * FP32
        return ops, nbytes, BF16_TENSOR_FLOPS
    if name == "group_norm":  # (B, C, H, W, eps, silu): x -> y bf16, fp32 scale and bias
        b, c, h, w, _eps, silu = shape
        n = b * c * h * w
        # stats: x, x·x, two sums (4 an element); apply: (x - mean)·rstd, then
        # ·scale + bias (4); SiLU: x·sigmoid(x) as negate, exp, add, divide, multiply (5)
        ops = n * (8 + (5 if silu else 0))
        return ops, 2 * n * BF16 + 2 * c * FP32, FP32_FLOPS
    if name == "group_norm_stats":  # (B, C, H, W): x -> S, SQ fp32 of each (batch, group)
        b, c, h, w = shape[:4]
        n = b * c * h * w
        return n * 4, n * BF16 + 2 * b * SD_GROUPS * FP32, FP32_FLOPS
    if name == "group_norm_apply":  # (B, C, H, W, eps, silu): x, S, SQ -> y
        b, c, h, w, _eps, silu = shape
        n = b * c * h * w
        ops = n * (4 + (5 if silu else 0))
        return ops, 2 * n * BF16 + 2 * c * FP32 + 2 * b * SD_GROUPS * FP32, FP32_FLOPS
    if name == "geglu":  # (M, K, N, r): x (M, K) · W (K, 2N) + fp32 bias [+ xd·up] -> (M, N)
        m, k, n, r = shape
        ops = 2 * m * k * 2 * n + 2 * m * r * 2 * n
        nbytes = (m * k + 2 * n * k + m * n + m * r + 2 * n * r) * BF16 + 2 * n * FP32
        return ops, nbytes, BF16_TENSOR_FLOPS
    raise KeyError(f"no work count for kernel {name!r}")


def kernel_bound(name: str, shape: tuple) -> dict:
    """{"bound_ms", "bound_by"} of one call of `name` at `shape`."""
    ops, nbytes, peak = work(name, shape)
    return {"bound_ms": bound_ms(ops, nbytes, peak), "bound_by": bound_by(ops, nbytes, peak)}
