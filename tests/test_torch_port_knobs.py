"""The JAX package's two flash-attention knobs in the port.

`LECO_FLASH_CROSS=1` admits cross-attention with Nq >= 256 to the kernels,
as the JAX package's `supports()` does; `LECO_FLASH_BWD` other than
"pallas" gives the 3-d route the plain fp32 backward from the whole
softmax, as the JAX package falls back to XLA. Both are read at call time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops import flash_attention as jax_fa
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops.attention import _xla_attention, multi_head_attention


@pytest.mark.parametrize("cross", ["0", "1"])
@pytest.mark.parametrize("nk", [77, 256, 4096])
@pytest.mark.parametrize("nq", [64, 256, 4096])
def test_dispatch_matches_jax_supports(nq, nk, cross, monkeypatch):
    monkeypatch.setenv("LECO_FLASH_CROSS", cross)
    assert fa.supports(nq, nk, torch.bfloat16, torch.device("cuda")) is bool(
        jax_fa.supports(nq, nk))


def test_cross_knob_routes_cross_attention_at_call_time(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 256, 32), (2, 77, 32), (2, 77, 32)))
    calls = []
    real = fa.attn_fwd
    monkeypatch.setattr(fa, "attn_fwd", lambda *a: calls.append(a[1].shape) or real(*a))
    multi_head_attention(q, k, v, num_heads=2, backend="flash")
    assert calls == []
    monkeypatch.setenv("LECO_FLASH_CROSS", "1")
    out = multi_head_attention(q, k, v, num_heads=2, backend="flash")
    assert calls == [(4, 77, 16)]
    ref = _xla_attention(*(t.reshape(2, -1, 2, 16) for t in (q, k, v)), 16**-0.5, False)
    np.testing.assert_allclose(out.numpy(), ref.reshape(2, 256, 32).numpy(), atol=1e-5)


def _grads(q, k, v, g, scale):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention_3d(qt, kt, vt, scale).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("nk", [256, 77])
def test_plain_backward_knob(nk, monkeypatch):
    """LECO_FLASH_BWD=xla: no call reaches the kernels' backward pair; the
    grads are the JAX package's XLA backward's (fp32, summation order
    apart) and the default route's (whose plain versions round dS to the
    inputs' dtype, here fp32)."""
    rng = np.random.default_rng(nk)
    q, g = (rng.standard_normal((2, 256, 64)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, nk, 64)).astype(np.float32) for _ in range(2))
    scale = 64**-0.5
    default = _grads(q, k, v, g, scale)

    calls = []
    for name in ("attn_bwd_dq", "attn_bwd_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, real=real: calls.append(1) or real(*a))
    monkeypatch.setenv("LECO_FLASH_BWD", "xla")
    plain = _grads(q, k, v, g, scale)
    assert calls == []

    def f(q, k, v):
        return jnp.sum(jax_fa._flash_3d(q, k, v, scale) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, got, ref, dflt in zip(("dq", "dk", "dv"), plain, want, default):
        ref = np.asarray(ref)
        size = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=1e-5 * size, err_msg=name)
        np.testing.assert_allclose(got, dflt, atol=1e-5 * size, err_msg=name)
