"""The port's fused GroupNorm-SiLU-conv (leco_tpu_torch/ops/gn_conv.py)
against the JAX package's.

The JAX kernel `_gnconv_kernel` runs in interpret mode on the CPU
(`LECO_GNCONV_INTERPRET=1`, as tests/test_gn_conv.py runs it); the port's
side runs the kernel's plain version. The port is NCHW/OIHW, the JAX package
NHWC/HWIO: inputs come from a numpy seed and are transposed at the
boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leco_tpu.ops import gn_conv as jgc
from leco_tpu_torch.models.unet import ResnetBlock2D
from leco_tpu_torch.ops import gn_conv

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("LECO_GNCONV_INTERPRET", "1")


def _inputs(b, cin, h, w, cout, seed=0):
    """x, gn scale, gn bias, temb (B, Cin), weight OIHW, bias."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, cin, h, w) + f(1, cin, 1, 1), 1.0 + 0.1 * f(cin), 0.1 * f(cin),
            f(b, cin), 0.05 * f(cout, cin, 3, 3), 0.1 * f(cout))


def _nhwc(x):
    return x.transpose(0, 2, 3, 1)


def _hwio(w):
    return w.transpose(2, 3, 1, 0)


def _jax_affine(x, gs, gb, t, groups, jdt=jnp.float32):
    return jgc.affine_from_gn(jnp.asarray(_nhwc(x)).astype(jdt), jnp.asarray(gs),
                              jnp.asarray(gb), jnp.asarray(t), groups, 1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_affine_matches_jax(dtype, atol):
    """(a, s) in fp32 from the same inputs; in bf16 the x·x product rounds
    to bf16 on both sides before the fp32 sums."""
    jdt, tdt = DTYPES[dtype]
    x, gs, gb, t, _, _ = _inputs(2, 64, 8, 8, 64)
    aj, sj = _jax_affine(x, gs, gb, t, 32, jdt)
    a, s = gn_conv.affine_from_gn(torch.from_numpy(x).to(tdt), torch.from_numpy(gs),
                                  torch.from_numpy(gb), torch.from_numpy(t), 32, 1e-5)
    assert a.dtype == s.dtype == torch.float32 and a.shape == (2, 64)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=atol, atol=atol)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=atol, atol=atol)


def test_affine_is_the_group_norm_of_x_plus_temb():
    x, gs, gb, t, _, _ = (torch.from_numpy(a) for a in _inputs(2, 32, 6, 6, 32, seed=1))
    a, s = gn_conv.affine_from_gn(x, gs, gb, t, 8, 1e-5)
    want = F.group_norm(x + t[:, :, None, None], 8, gs, gb, 1e-5)
    np.testing.assert_allclose((a[:, :, None, None] * x + s[:, :, None, None]).numpy(),
                               want.numpy(), atol=1e-4)


@pytest.mark.parametrize("b,cin,h,w,cout", [
    (2, 128, 8, 8, 128),
    (1, 128, 16, 16, 256),
    (2, 384, 8, 8, 128),
    (1, 256, 12, 8, 128),
])
def test_kernel_plain_matches_jax_kernel(b, cin, h, w, cout):
    x, gs, gb, t, wt, bias = _inputs(b, cin, h, w, cout, seed=2)
    aj, sj = _jax_affine(x, gs, gb, t, 32)
    want = jgc.affine_silu_conv(jnp.asarray(_nhwc(x)), aj, sj, jnp.asarray(_hwio(wt)),
                                jnp.asarray(bias))
    got = gn_conv.gnconv3x3_plain(torch.from_numpy(x), torch.from_numpy(np.array(aj)),
                                  torch.from_numpy(np.array(sj)), torch.from_numpy(wt),
                                  torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), atol=1e-4)


def test_bf16_kernel_plain_matches_jax_kernel():
    """bf16 at the bound of tests/test_gn_conv.py (atol 0.03, rtol 0.02)."""
    x, gs, gb, t, wt, bias = _inputs(2, 128, 8, 8, 128, seed=3)
    aj, sj = _jax_affine(x, gs, gb, t, 32, jnp.bfloat16)
    want = jgc.affine_silu_conv(jnp.asarray(_nhwc(x)).astype(jnp.bfloat16), aj, sj,
                                jnp.asarray(_hwio(wt)).astype(jnp.bfloat16), jnp.asarray(bias))
    got = gn_conv.gnconv3x3_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(aj)),
        torch.from_numpy(np.array(sj)), torch.from_numpy(wt).bfloat16(),
        torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float().numpy()), np.asarray(want, np.float32),
                               atol=0.03, rtol=0.02)


def test_references_match_jax():
    x, gs, gb, t, wt, bias = _inputs(2, 32, 8, 8, 16, seed=4)
    aj, sj = _jax_affine(x, gs, gb, t, 8)
    a, s = (torch.from_numpy(np.array(v)) for v in (aj, sj))
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias)
    np.testing.assert_allclose(
        _nhwc(gn_conv.apply_affine_silu(tx, a, s).numpy()),
        np.asarray(jgc.apply_affine_silu(jnp.asarray(_nhwc(x)), aj, sj)), atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(gn_conv._conv_reference(tx, a, s, tw, tb).numpy()),
        np.asarray(jgc._conv_reference(jnp.asarray(_nhwc(x)), aj, sj,
                                       jnp.asarray(_hwio(wt)), jnp.asarray(bias), True)),
        atol=1e-5)
    np.testing.assert_allclose(
        _nhwc(gn_conv._reference(tx, torch.from_numpy(gs), torch.from_numpy(gb),
                                 torch.from_numpy(t), tw, tb, 8, 1e-5).numpy()),
        np.asarray(jgc._reference(jnp.asarray(_nhwc(x)), jnp.asarray(gs), jnp.asarray(gb),
                                  jnp.asarray(t), jnp.asarray(_hwio(wt)), jnp.asarray(bias),
                                  8, 1e-5, True)),
        atol=1e-4)


def test_gradients_match_jax_custom_vjp():
    """affine_from_gn + affine_silu_conv against jax.grad through the JAX
    package's custom VJP (kernel forward in interpret mode, reference
    backward), fp32: x gets its gradient through both the data path and
    the statistics."""
    x, gs, gb, t, wt, bias = _inputs(2, 128, 8, 8, 128, seed=5)

    def loss_jax(x, gs, gb, t, w, b):
        a, s = jgc.affine_from_gn(x, gs, gb, t, 32, 1e-5)
        return jnp.sum(jgc.affine_silu_conv(x, a, s, w, b) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2, 3, 4, 5))(
        jnp.asarray(_nhwc(x)), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(t),
        jnp.asarray(_hwio(wt)), jnp.asarray(bias))
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, gs, gb, t, wt, bias)]
    a, s = gn_conv.affine_from_gn(ts[0], ts[1], ts[2], ts[3], 32, 1e-5)
    (gn_conv.affine_silu_conv(ts[0], a, s, ts[4], ts[5]) ** 2).sum().backward()
    got = [v.grad.numpy() for v in ts]
    got[0], got[4] = _nhwc(got[0]), _hwio(got[4])
    for g, wnt in zip(got, want):
        scale = float(np.abs(wnt).max())
        np.testing.assert_allclose(g, np.asarray(wnt), atol=2e-5 * scale)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    gn_conv.gnconv3x3.launches = 0
    x, gs, gb, t, wt, bias = (torch.from_numpy(v) for v in _inputs(1, 8, 6, 6, 8, seed=6))
    a, s = gn_conv.affine_from_gn(x, gs, gb, t, 4, 1e-5)
    assert torch.equal(gn_conv.gnconv3x3(x, a, s, wt, bias),
                       gn_conv.gnconv3x3_plain(x, a, s, wt, bias))
    assert gn_conv.gnconv3x3.launches == 0


@pytest.mark.parametrize("shape,cout,dtype,device,want", [
    ((2, 320, 16, 16), 320, torch.bfloat16, "cuda", True),
    ((1, 2560, 8, 8), 1280, torch.bfloat16, "cuda", True),
    ((2, 1280, 4, 4), 1280, torch.bfloat16, "cuda", True),
    ((2, 1280, 2, 2), 1280, torch.bfloat16, "cuda", False),  # h, w < 4
    ((2, 64, 16, 16), 320, torch.bfloat16, "cuda", False),  # thin input
    ((2, 320, 16, 16), 4, torch.bfloat16, "cuda", False),  # thin output
    ((2, 320, 16, 16), 320, torch.float32, "cuda", False),  # fp32 on CUDA
    ((2, 320, 16, 16), 320, torch.float32, "cpu", True),  # CPU: the plain version
    ((2, 320, 64, 64), 320, torch.bfloat16, "cuda", False),  # above 16 x 16
    ((2, 320, 64, 64), 320, torch.float32, "cpu", False),  # above 16 x 16
])
def test_supports_is_the_jax_shape_gate(shape, cout, dtype, device, want):
    assert gn_conv.supports(shape, cout, dtype, torch.device(device)) is want


def test_knob_reads_the_jax_variable(monkeypatch):
    monkeypatch.delenv("LECO_RESNET_FUSED", raising=False)
    assert not gn_conv.enabled()
    monkeypatch.setenv("LECO_RESNET_FUSED", "1")
    assert gn_conv.enabled()


def _resnet(cin, cout, seed, lora_on_conv2=False):
    from leco_tpu_torch import lora

    gen = torch.Generator().manual_seed(seed)
    block = ResnetBlock2D(cin, cout, 16, 4)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(generator=gen).mul_(0.2)
    if lora_on_conv2:
        block.conv2.add_lora(lora.LoRASpec(rank=2, alpha=1.0, network_type="c3lier"), gen)
    x = torch.randn((2, cin, 8, 8), generator=gen)
    temb = torch.randn((2, 16), generator=gen)
    return block, x, temb


@pytest.mark.parametrize("lora_on_conv2,fused_convs", [(False, 2), (True, 1)])
def test_resnet_fuses_the_convs_without_lora(lora_on_conv2, fused_convs, monkeypatch):
    """With the knob on and the shape gate forced open (the block is 8 and
    16 channels wide), each conv without a LoRA branch takes the fused
    path, and the block computes what it computes with the knob off."""
    block, x, temb = _resnet(8, 16, seed=7, lora_on_conv2=lora_on_conv2)
    with torch.no_grad():
        monkeypatch.setenv("LECO_RESNET_FUSED", "0")
        want = block(x, temb)
        monkeypatch.setenv("LECO_RESNET_FUSED", "1")
        monkeypatch.setattr(gn_conv, "supports", lambda *a: True)
        monkeypatch.setattr("leco_tpu_torch.ops.conv.HOT_MIN_CHANNELS", 8)
        calls = []
        real = gn_conv.affine_silu_conv
        monkeypatch.setattr(gn_conv, "affine_silu_conv",
                            lambda *a: calls.append(a[3].shape) or real(*a))
        got = block(x, temb)
    assert len(calls) == fused_convs
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
