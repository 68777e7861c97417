"""The roofline bounds that chip_smoke.py sets beside each kernel's time
(`leco_tpu_torch/kernels/roofline.py`), against operations and bytes
counted by hand at the shape where each kernel is timed."""

import pytest

import chip_smoke
from leco_tpu_torch.kernels import roofline

# name, timed shape, operations, bytes, peak: each term is one operand
HAND_COUNTED = [
    # 2 products of 2·Nq·Nk·D; q, k, v, o bf16 and lse fp32
    ("attn_fwd", (16, 4096, 4096, 40), 2 * 2 * 16 * 4096 * 4096 * 40,
     4 * 16 * 4096 * 40 * 2 + 16 * 4096 * 4, roofline.BF16_TENSOR_FLOPS),
    # 3 products (S, dP, dQ); q, dO, dq, k, v bf16; lse, delta fp32
    ("attn_bwd_dq", (8, 4096, 4096, 40), 3 * 2 * 8 * 4096 * 4096 * 40,
     5 * 8 * 4096 * 40 * 2 + 2 * 8 * 4096 * 4, roofline.BF16_TENSOR_FLOPS),
    # 4 products (S, dV, dP, dK); q, dO, k, v, dk, dv bf16; lse, delta fp32
    ("attn_bwd_dkv", (8, 4096, 4096, 40), 4 * 2 * 8 * 4096 * 4096 * 40,
     6 * 8 * 4096 * 40 * 2 + 2 * 8 * 4096 * 4, roofline.BF16_TENSOR_FLOPS),
    # 5 heads of 64: 2 products over C = 320; q, k, v, o (B, N, C) bf16
    ("attn_fwd_packed", (4, 4096, 4096, 320, 5), 2 * 2 * 4 * 4096 * 4096 * 320,
     4 * 4 * 4096 * 320 * 2, roofline.BF16_TENSOR_FLOPS),
    # 2·B·H·W·9·Cin·Cout; x, w, y bf16, bias fp32
    ("conv3x3", (2, 640, 64, 64, 640), 2 * 2 * 64 * 64 * 9 * 640 * 640,
     2 * 640 * 4096 * 2 + 9 * 640 * 640 * 2 + 2 * 640 * 4096 * 2 + 640 * 4,
     roofline.BF16_TENSOR_FLOPS),
    # the same conv; x, w, y bf16, bias and the (B, Cin) affine a, s fp32
    ("gnconv3x3", (2, 1280, 8, 8, 1280), 2 * 2 * 8 * 8 * 9 * 1280 * 1280,
     2 * 1280 * 64 * 2 + 9 * 1280 * 1280 * 2 + 2 * 1280 * 64 * 2 + 1280 * 4 + 2 * 2 * 1280 * 4,
     roofline.BF16_TENSOR_FLOPS),
    # 8 fp32 operations an element, no SiLU; x, y bf16, scale, bias fp32
    ("group_norm", (2, 320, 64, 64, 1e-6, False), 8 * 2 * 320 * 4096,
     2 * 2 * 320 * 4096 * 2 + 2 * 320 * 4, roofline.FP32_FLOPS),
    # x (8192, 320) · W (320, 2560): value and gate halves; x, W, out bf16, bias fp32
    ("geglu", (8192, 320, 1280, 0), 2 * 8192 * 320 * 2560,
     8192 * 320 * 2 + 2560 * 320 * 2 + 8192 * 1280 * 2 + 2560 * 4, roofline.BF16_TENSOR_FLOPS),
]


# the entries that spatial parallelism adds, at the shapes chip_smoke times
# them (phase kernels_sharded)
SHARDED_HAND_COUNTED = [
    # the conv of 32 output rows from a window of 34 input rows
    ("conv3x3_rows", (2, 320, 32, 64, 320), 2 * 2 * 32 * 64 * 9 * 320 * 320,
     2 * 320 * 34 * 64 * 2 + 9 * 320 * 320 * 2 + 2 * 320 * 32 * 64 * 2 + 320 * 4,
     roofline.BF16_TENSOR_FLOPS),
    # 2 output rows from 4, the affine a, s
    ("gnconv3x3_rows", (2, 1280, 2, 8, 1280, True, True), 2 * 2 * 2 * 8 * 9 * 1280 * 1280,
     2 * 1280 * 4 * 8 * 2 + 9 * 1280 * 1280 * 2 + 2 * 1280 * 16 * 2 + 1280 * 4
     + 2 * 2 * 1280 * 4, roofline.BF16_TENSOR_FLOPS),
    # x, x·x and two sums an element; x bf16, the (2, 32, 2) sums fp32
    ("group_norm_stats", (2, 320, 32, 64), 4 * 2 * 320 * 2048,
     2 * 320 * 2048 * 2 + 2 * 2 * 32 * 4, roofline.FP32_FLOPS),
    # 4 an element, 5 more for the SiLU; x, y bf16, scale, bias and the sums fp32
    ("group_norm_apply", (2, 320, 32, 64, 1e-6, False), 4 * 2 * 320 * 2048,
     2 * 2 * 320 * 2048 * 2 + 2 * 320 * 4 + 2 * 2 * 32 * 4, roofline.FP32_FLOPS),
]


@pytest.mark.parametrize("name,shape,ops,nbytes,peak", SHARDED_HAND_COUNTED,
                         ids=[row[0] for row in SHARDED_HAND_COUNTED])
def test_sharded_work_matches_the_hand_count(name, shape, ops, nbytes, peak):
    assert roofline.work(name, shape) == (ops, nbytes, peak)
    assert tuple(chip_smoke.SHARDED_TIMED[name]) == shape


@pytest.mark.parametrize("name,shape,ops,nbytes,peak", HAND_COUNTED,
                         ids=[row[0] for row in HAND_COUNTED])
def test_work_matches_the_hand_count(name, shape, ops, nbytes, peak):
    assert roofline.work(name, shape) == (ops, nbytes, peak)
    bound = roofline.kernel_bound(name, shape)
    assert bound["bound_ms"] == pytest.approx(max(ops / peak, nbytes / 3.35e12) * 1e3)


def test_the_numbers_of_the_two_level0_forwards():
    """SD1.5's (16, 4096, 40) and SD2.1's (20, 4096, 64): both bound by the
    tensor cores, at 43.4 and 86.9 us."""
    sd15 = roofline.kernel_bound("attn_fwd", (16, 4096, 4096, 40))
    sd21 = roofline.kernel_bound("attn_fwd", (20, 4096, 4096, 64))
    assert sd15["bound_by"] == sd21["bound_by"] == "operations"
    assert sd15["bound_ms"] == pytest.approx(0.04343, rel=1e-3)
    assert sd21["bound_ms"] == pytest.approx(0.08686, rel=1e-3)


@pytest.mark.parametrize("ops,nbytes,want_ms,want_by", [
    (989e9, 0.0, 1.0, "operations"),
    (0.0, 3.35e9, 1.0, "bytes"),
    (989e9, 6.7e9, 2.0, "bytes"),
])
def test_bound_is_the_larger_of_the_two_times(ops, nbytes, want_ms, want_by):
    assert roofline.bound_ms(ops, nbytes) == pytest.approx(want_ms)
    assert roofline.bound_by(ops, nbytes) == want_by


def test_every_timed_shape_of_chip_smoke_has_a_bound():
    timed = {**chip_smoke.TIMED_SHAPE, chip_smoke.PACKED: chip_smoke.PACKED_TIMED,
             **chip_smoke.FUSED_TIMED}
    assert set(timed) == set(chip_smoke.KERNELS)
    for name, shape in timed.items():
        assert roofline.kernel_bound(name, shape)["bound_ms"] > 0
    assert {n: tuple(s) for n, s, *_ in HAND_COUNTED} == timed
