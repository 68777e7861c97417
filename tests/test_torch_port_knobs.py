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


# ---------------------------------------------------------------------------
# the fused knobs' gates at the shapes the JAX gates refuse for TPU reasons
# (a VMEM budget, gnconv's v5e table): the port decides them by the H100's
# own timing of the kernel route against the knob-off route
# (`python -m leco_tpu_torch.kernels.time_gates`, PERF.md section 6)
# ---------------------------------------------------------------------------

from leco_tpu.ops import geglu as jax_geglu  # noqa: E402
from leco_tpu.ops import gn_conv as jax_gn_conv  # noqa: E402
from leco_tpu.ops import group_norm as jax_gn  # noqa: E402
from leco_tpu_torch.kernels.time_gates import decide, gnconv_shapes  # noqa: E402
from leco_tpu_torch.ops import geglu, gn_conv  # noqa: E402
from leco_tpu_torch.ops import group_norm as gn  # noqa: E402

CUDA = torch.device("cuda")  # a value only: no GPU is needed


@pytest.mark.parametrize("b,c,h,w", [(2, 320, 128, 128), (2, 640, 64, 64), (2, 320, 96, 96)])
def test_group_norm_gate_keeps_the_kernel_where_jax_refuses(b, c, h, w):
    assert not jax_gn.supports((b, h, w, c), jnp.bfloat16)  # its VMEM budget
    assert gn.supports(torch.bfloat16, CUDA)  # 7-9x faster than F.group_norm


@pytest.mark.parametrize("m", [2 * 1024, 2 * 256, 2 * 64])
def test_geglu_gate_keeps_the_kernel_at_k_1280(m):
    assert jax_geglu._pick(m, 5120, 1280, 2) is None  # no block fits its VMEM
    assert geglu.supports(torch.bfloat16, CUDA)  # 6-12x faster than F.linear + gelu


@pytest.mark.parametrize("b,n,c,heads", [(2, 4096, 640, 10), (2, 9216, 320, 5)])
def test_packed_gate_keeps_the_kernel_where_jax_refuses(b, n, c, heads):
    assert not jax_fa.supports_packed(n, n, c, heads, 2)
    assert fa.supports_packed(n, n, c, heads)  # faster than the 3-d route


@pytest.mark.parametrize("shape", gnconv_shapes(), ids=str)
def test_gnconv_gate_follows_the_h100_timing(shape):
    """Every refused resnet conv of the timed runs is above 16 x 16; with
    the fused configuration's other knobs on, the unfused route beat the
    kernel route at every one, so the port refuses them all, as JAX does."""
    b, cin, h, w, cout = shape
    assert h > gn_conv.MAX_FUSED_SIDE
    # the v5e table sends every shape above 16 x 16 to XLA but one, where it
    # had measured its kernel faster; the H100 measured its own slower there
    jax_admits = jax_gn_conv.supports((b, h, w, cin), cout, jnp.bfloat16)
    assert jax_admits is ((cin, h, w, cout) == (1280, 32, 32, 640))
    assert not gn_conv.supports((b, cin, h, w), cout, torch.bfloat16, CUDA)
    # the same shape on the CPU goes the same way (the plain version there)
    assert not gn_conv.supports((b, cin, h, w), cout, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("h,w,want", [(16, 16, True), (8, 8, True), (16, 12, True),
                                      (17, 16, False), (16, 20, False), (4, 4, True)])
def test_gnconv_gate_splits_at_16(h, w, want):
    """At 16 x 16 and below both gates keep the kernel (the v5e table's
    SD shapes and its rule for the rest); above, neither does."""
    assert gn_conv.supports((2, 1280, h, w), 1280, torch.bfloat16, CUDA) is want
    assert jax_gn_conv.supports((2, h, w, 1280), 1280, jnp.bfloat16) is want


@pytest.mark.parametrize("knob_ms,off_ms,want", [
    ([1.12, 1.11, 1.2], [1.0, 1.0, 0.9], "off"),  # slower by more than 10%
    ([1.09, 1.09, 1.5], [1.0, 1.0, 1.0], "kernel"),  # a near-tie keeps the kernel
    ([0.5, 0.5, 0.5], [1.0, 1.0, 1.0], "kernel"),
])
def test_gate_decision_needs_the_margin(knob_ms, off_ms, want):
    assert decide(knob_ms, off_ms) == want
