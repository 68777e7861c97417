"""The yardstick's peaks and the attention core's least time.

NVIDIA H100 SXM at its 700 W limit (the data sheet's dense rates): 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. A card set below
700 W runs slower; the run records its power limit beside every share.

The attention core of one call, at (BH, Nq, Nk, D) in bf16: S = Q K^T and
O = P V, 4 BH Nq Nk D operations; q, k and v read once and o written once.
Its least time is the larger of the operations over the tensor peak and the
bytes over the memory rate.
"""

from __future__ import annotations

BF16_TENSOR_FLOPS = 989e12
BYTES_PER_S = 3.35e12
BF16 = 2


def attention_core_work(bh: int, nq: int, nk: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one attention core."""
    ops = 4.0 * bh * nq * nk * d
    nbytes = float(bh * d * BF16 * (2 * nq + 2 * nk))
    return ops, nbytes


def bound_ms(ops: float, nbytes: float, peak: float = BF16_TENSOR_FLOPS) -> float:
    """max(ops / peak, bytes / memory rate), in milliseconds."""
    return max(ops / peak, nbytes / BYTES_PER_S) * 1e3
