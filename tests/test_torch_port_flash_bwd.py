"""The port's plain flash-attention backward pair against the JAX package's.

`attn_bwd_dq_plain` and `attn_bwd_dkv_plain` are what the Hopper kernels
(`csrc/flash_bwd_dq.cu`, `csrc/flash_bwd_dkv.cu`) are held to on the card;
here they are held directly to `_flash_bwd_3d`, whose Pallas kernels
(`_attn_bwd_dq_kernel`, `_attn_bwd_dkv_kernel`) run in interpret mode on the
CPU, at every head dim the kernels take, with Nk = Nq and with Nk = 77 (the
JAX side pads the keys to 128 and masks them). Inputs are made from a seed
with numpy and rounded to the working dtype identically on both sides; lse
is the JAX forward's and delta = rowsum(dO * O) is computed once, in numpy,
and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops.flash_attention import _flash_bwd_3d, _flash_fwd_3d
from leco_tpu_torch.ops import flash_attention as fa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the two sides differ by summation order only, relative to the
# gradient's largest magnitude. bf16: both sides round P^T, dS and the
# outputs at the same places, so an output differs by at most one bf16 ulp
# of its own value (a sum that lands near a rounding boundary), which is at
# most 2^-7 of max|ref|
RTOL = {"float32": 1e-5, "bfloat16": 2**-7}
BH = 2


def _arrays(seed, nq, nk, d):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((BH, nq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((BH, nk, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nq,nk", [(256, 256), (256, 77)])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_plain_backward_pair_matches_jax_kernels(d, nq, nk, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = _arrays(d + nk, nq, nk, d)
    scale = d**-0.5
    qj, kj, vj, gj = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        o, lse = _flash_fwd_3d(qj, kj, vj, scale)
        delta = np.sum(np.asarray(gj, np.float32) * np.asarray(o, np.float32), axis=-1,
                       keepdims=True)
        want = _flash_bwd_3d(qj, kj, vj, lse, jnp.asarray(delta), gj, scale)
    qt, kt, vt, gt = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                      for x in (qj, kj, vj, gj))
    lse_t = torch.from_numpy(np.array(lse)[..., 0])
    delta_t = torch.from_numpy(delta[..., 0])
    dq = fa.attn_bwd_dq_plain(qt, kt, vt, gt, lse_t, delta_t, scale)
    dk, dv = fa.attn_bwd_dkv_plain(qt, kt, vt, gt, lse_t, delta_t, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == tdt and tuple(got.shape) == ref.shape, name
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= RTOL[dtype] * np.abs(ref).max(), (name, err, np.abs(ref).max())
