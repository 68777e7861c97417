"""The port's flash attention against the JAX package's Pallas kernels.

The JAX side runs its kernels in interpret mode on the CPU, as
tests/test_flash_attention.py does; the port's side runs the kernels' plain
PyTorch versions (what a wrapper takes for a CPU tensor). Inputs are made
from a seed with numpy and rounded to bf16 identically on both sides. The
packed-layout kernel (`LECO_FLASH_PACKED=1`) is held to the JAX package's
`flash_attention_packed` the same way, its shape rule to `supports_packed`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops import flash_attention as jax_fa
from leco_tpu.ops.flash_attention import _flash_fwd_3d, flash_attention
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops.attention import _xla_attention, multi_head_attention

SHAPES = [(256, 256, 2, 40), (512, 512, 4, 64), (512, 77, 2, 40)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the two sides differ by summation order only; bf16: the bound of
# tests/test_flash_attention.py (outputs rounded to bf16)
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,nk,heads,d", SHAPES)
def test_forward_matches_jax_kernel(n, nk, heads, d, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(0, (heads, n, d), (heads, nk, d), (heads, nk, d))
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = _flash_fwd_3d(
            *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), scale
        )
    o_t, lse_t = fa.attn_fwd_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale
    )
    assert o_t.dtype == tdt and lse_t.dtype == torch.float32
    np.testing.assert_allclose(
        o_t.float().numpy(), np.asarray(o_j, np.float32), atol=ATOL[dtype]
    )
    # lse is fp32 on both sides, from logits of identically rounded inputs
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=2e-5)


@pytest.mark.parametrize("n,nk,heads,d", [(256, 256, 2, 40), (512, 77, 2, 40)])
def test_gradients_match_jax_pallas_backward(n, nk, heads, d, monkeypatch):
    """The port's autograd.Function (plain dQ and dK/dV on the CPU) against
    jax.grad through the Pallas backward kernels, fp32."""
    monkeypatch.setenv("LECO_FLASH_BWD", "pallas")
    q, k, v = _inputs(1, (1, n, heads, d), (1, nk, heads, d), (1, nk, heads, d))
    scale = d**-0.5

    def f_jax(q, k, v):
        return jnp.sum(flash_attention(q, k, v, scale) ** 2)

    with pltpu.force_tpu_interpret_mode():
        g_jax = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.flash_attention(qt, kt, vt, scale) ** 2).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    fa.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, *[(2, 256, 40)] * 3))
    o, lse = fa.attn_fwd(q, k, v, 0.1)
    o_p, lse_p = fa.attn_fwd_plain(q, k, v, 0.1)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (o * o).sum(-1)
    assert torch.equal(fa.attn_bwd_dq(q, k, v, o, lse, delta, 0.1),
                       fa.attn_bwd_dq_plain(q, k, v, o, lse, delta, 0.1))
    for a, b in zip(fa.attn_bwd_dkv(q, k, v, o, lse, delta, 0.1),
                    fa.attn_bwd_dkv_plain(q, k, v, o, lse, delta, 0.1)):
        assert torch.equal(a, b)
    o2 = fa.attn_fwd_packed(q.reshape(1, 512, 40), k.reshape(1, 512, 40),
                            v.reshape(1, 512, 40), 1, 0.1)
    assert torch.equal(o2, fa.attn_fwd_packed_plain(q.reshape(1, 512, 40), k.reshape(1, 512, 40),
                                                    v.reshape(1, 512, 40), 1, 0.1))
    assert fa.launch_counts() == {"attn_fwd": 0, "attn_bwd_dq": 0, "attn_bwd_dkv": 0,
                                  "attn_fwd_packed": 0}


@pytest.mark.parametrize(
    "nq,nk,dtype,device,want",
    [
        (4096, 4096, torch.bfloat16, "cuda", True),
        (1024, 1024, torch.bfloat16, "cuda", True),
        (256, 256, torch.bfloat16, "cuda", True),
        (64, 64, torch.bfloat16, "cuda", False),  # mid block -> plain
        (4096, 77, torch.bfloat16, "cuda", False),  # cross-attention -> plain
        (4096, 4096, torch.float32, "cuda", False),  # fp32 on CUDA -> plain
        (4096, 4096, torch.float32, "cpu", True),  # CPU: the plain versions
    ],
)
def test_dispatch_rule(nq, nk, dtype, device, want):
    assert fa.supports(nq, nk, dtype, torch.device(device)) is want


@pytest.mark.parametrize("n,nk,routed", [(256, 256, True), (64, 64, False), (256, 77, False)])
def test_multi_head_attention_routes_by_shape(n, nk, routed, monkeypatch):
    calls = []
    real = fa.flash_attention_3d
    monkeypatch.setattr(fa, "flash_attention_3d", lambda *a: calls.append(1) or real(*a))
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, (2, n, 32), (2, nk, 32), (2, nk, 32)))
    out = multi_head_attention(q, k, v, num_heads=2, backend="flash")
    ref = _xla_attention(*(t.reshape(2, -1, 2, 16) for t in (q, k, v)), 16**-0.5, False)
    assert bool(calls) is routed
    np.testing.assert_allclose(out.numpy(), ref.reshape(2, n, 32).numpy(), atol=1e-5)


def test_plain_attention_matches_jax_xla_attention():
    from leco_tpu.ops.attention import _xla_attention as jax_xla_attention

    q, k, v = _inputs(4, (2, 64, 2, 16), (2, 77, 2, 16), (2, 77, 2, 16))
    want = jax_xla_attention(*map(jnp.asarray, (q, k, v)), 0.25, True)
    got = _xla_attention(*map(torch.from_numpy, (q, k, v)), 0.25, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


PACKED_SHAPES = [(2, 256, 256, 2, 40), (1, 256, 300, 2, 64), (1, 512, 512, 4, 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,n,nk,heads,d", PACKED_SHAPES)
def test_packed_forward_matches_jax_kernel(b, n, nk, heads, d, dtype):
    """`attn_fwd_packed_plain` against `_attn_kernel_packed` in interpret
    mode; Nk = 300 pads to 384 and masks the padding."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(5, (b, n, heads * d), (b, nk, heads * d), (b, nk, heads * d))
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        want = jax_fa.flash_attention_packed(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                             heads, scale)
    got = fa.attn_fwd_packed_plain(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), heads, scale)
    assert got.dtype == tdt and got.shape == (b, n, heads * d)
    atol = {"float32": 1e-5, "bfloat16": ATOL["bfloat16"]}[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("b,n,nk,heads,d", PACKED_SHAPES[:2])
def test_packed_gradients_match_jax(b, n, nk, heads, d):
    """FlashAttentionPacked (plain forward, plain fp32 backward on the CPU)
    against jax.grad through `flash_attention_packed`'s custom VJP, fp32."""
    q, k, v = _inputs(6, (b, n, heads * d), (b, nk, heads * d), (b, nk, heads * d))
    scale = d**-0.5

    def f_jax(q, k, v):
        return jnp.sum(jax_fa.flash_attention_packed(q, k, v, heads, scale) ** 2)

    with pltpu.force_tpu_interpret_mode():
        g_jax = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.flash_attention_packed(qt, kt, vt, heads, scale) ** 2).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_supports_packed_matches_jax(itemsize, monkeypatch):
    """The port's packed rule is the JAX package's with the VMEM arithmetic
    (its q-block picker, a TPU limit) taken out: it admits every shape JAX
    admits at either itemsize, and the ones JAX's budget alone refuses."""
    grid = [(nq, nk, c, heads) for nq in (64, 256, 300, 1024, 4096, 8192, 16384)
            for nk in (77, 256, 300, 1024, 4096, 8192) for c, heads in
            ((320, 5), (320, 8), (640, 10), (1280, 20), (1280, 8), (96, 7))]
    got = [fa.supports_packed(*g) for g in grid]
    within_vmem = [jax_fa.supports_packed(*g, itemsize) for g in grid]
    assert all(ok for ok, jax_ok in zip(got, within_vmem) if jax_ok)
    assert got != within_vmem
    monkeypatch.setattr(jax_fa, "_pick_q_block_packed", lambda *a: 128)
    assert got == [jax_fa.supports_packed(*g, itemsize) for g in grid]
    assert any(got) and not all(got)
    # every self-attention of SD1.5 and SD2.1 at 512 px and of SDXL at 1024
    # px takes the packed route
    for n, c, heads in ((4096, 320, 5), (1024, 640, 10), (256, 1280, 20), (4096, 320, 8),
                        (1024, 640, 8), (256, 1280, 8), (4096, 640, 10), (1024, 1280, 20)):
        assert fa.supports_packed(n, n, c, heads)


@pytest.mark.parametrize("n,nk,knob,route", [(256, 256, "1", "packed"), (256, 256, "0", "3d"),
                                             (256, 256, None, "3d"), (64, 64, "1", "plain"),
                                             (256, 77, "1", "plain")])
def test_packed_knob_routes_at_call_time(n, nk, knob, route, monkeypatch):
    if knob is None:
        monkeypatch.delenv("LECO_FLASH_PACKED", raising=False)
    else:
        monkeypatch.setenv("LECO_FLASH_PACKED", knob)
    calls = []
    real_3d, real_packed = fa.flash_attention_3d, fa.flash_attention_packed
    monkeypatch.setattr(fa, "flash_attention_3d", lambda *a: calls.append("3d") or real_3d(*a))
    monkeypatch.setattr(fa, "flash_attention_packed",
                        lambda *a: calls.append("packed") or real_packed(*a))
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, (2, n, 32), (2, nk, 32), (2, nk, 32)))
    out = multi_head_attention(q, k, v, num_heads=2, backend="flash")
    ref = _xla_attention(*(t.reshape(2, -1, 2, 16) for t in (q, k, v)), 16**-0.5, False)
    assert calls == ([] if route == "plain" else [route])
    np.testing.assert_allclose(out.numpy(), ref.reshape(2, n, 32).numpy(), atol=1e-5)
