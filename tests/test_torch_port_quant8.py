"""The port's blockwise 8-bit quantization against `leco_tpu/train/quant8.py`:
the codebooks, the codes and absmax of seeded values, and dequantization,
padding and odd shapes included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.train import quant8 as jax_q8
from leco_tpu_torch.train import quant8


@pytest.fixture(scope="module")
def jax_cpu():
    jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("signed", [True, False])
def test_codebooks_are_bit_equal(signed):
    got = quant8.dynamic_codebook(signed)
    want = jax_q8.dynamic_codebook(signed)
    assert got.dtype == np.float32 and got.shape == (256,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(quant8.MIDPOINTS[signed],
                                  jax_q8._MID_SIGNED if signed else jax_q8._MID_UNSIGNED)


def _values(signed: bool, n: int = 100_000) -> np.ndarray:
    """Heavy-tailed values over many magnitudes (products of normals), so
    that every exponent level of the codebook is hit."""
    rng = np.random.default_rng(42)
    x = (rng.standard_normal(n) * rng.standard_normal(n) ** 3).astype(np.float32)
    return x if signed else np.abs(x)


@pytest.mark.parametrize("signed", [True, False])
def test_codes_of_100k_values_equal_jax(signed, jax_cpu):
    x = _values(signed)
    want = jax_q8.quantize_blockwise(jnp.asarray(x), signed)
    codes, absmax = quant8.quantize_blockwise(torch.from_numpy(x), signed)
    assert codes.dtype == torch.uint8 and absmax.dtype == torch.float32
    assert tuple(codes.shape) == want.codes.shape and tuple(absmax.shape) == want.absmax.shape
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(want.absmax))
    want_codes = np.asarray(want.codes).astype(np.int32)
    got_codes = codes.numpy().astype(np.int32)
    differ = np.flatnonzero(got_codes.reshape(-1) != want_codes.reshape(-1))
    # a mismatch can only be a value on a midpoint, one code apart
    normed = (np.pad(x, (0, want_codes.size - x.size)).reshape(want_codes.shape)
              / np.maximum(np.asarray(want.absmax), np.float32(1e-30))).reshape(-1)
    mids = quant8.MIDPOINTS[signed]
    for i in differ:
        assert abs(got_codes.reshape(-1)[i] - want_codes.reshape(-1)[i]) == 1
        assert normed[i] in mids
    assert len(differ) == 0, f"{len(differ)} midpoint ties"
    # every level of the codebook is used
    assert len(np.unique(got_codes)) > 200


@pytest.mark.parametrize("shape", [(4, 320), (1280, 16), (3, 5, 7), (2048,), (4097,), (1,)])
@pytest.mark.parametrize("signed", [True, False])
def test_dequantize_equals_jax_with_padding(shape, signed, jax_cpu):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    if not signed:
        x = np.abs(x)
    want = jax_q8.quantize_blockwise(jnp.asarray(x), signed)
    codes, absmax = quant8.quantize_blockwise(torch.from_numpy(x), signed)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want.codes))
    got = quant8.dequantize_blockwise(codes, absmax, shape, signed)
    back = np.asarray(jax_q8.dequantize_blockwise(want, shape, signed))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), back)


def test_zero_state_is_code_of_zero():
    codes, absmax = quant8.quantize_blockwise(torch.zeros(5000), True)
    assert torch.equal(quant8.dequantize_blockwise(codes, absmax, (5000,)), torch.zeros(5000))
    assert codes.shape == (3, quant8.BLOCK_SIZE)
