"""The port's 3x3 implicit-GEMM conv (leco_tpu_torch/ops/conv.py) against the
JAX package's.

The JAX kernel `_conv_kernel` runs in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode()`); the port's side runs the kernel's
plain version. The port is NCHW/OIHW, the JAX package NHWC/HWIO: inputs
come from a numpy seed and are transposed at the boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops import conv as jconv
from leco_tpu_torch import lora
from leco_tpu_torch.ops import conv

# fp32: summation order only; bf16: one rounding of outputs of size ~1
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(b, cin, h, w, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wt, bias


def _nhwc(x):
    return x.transpose(0, 2, 3, 1)


def _hwio(w):
    return w.transpose(2, 3, 1, 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,cin,h,w,cout,with_bias", [
    (2, 128, 8, 8, 128, True),
    (1, 64, 12, 8, 32, True),
    (2, 32, 8, 8, 48, False),
])
def test_kernel_plain_matches_jax_kernel(b, cin, h, w, cout, with_bias, dtype):
    jdt, tdt = DTYPES[dtype]
    x, wt, bias = _data(b, cin, h, w, cout)
    with pltpu.force_tpu_interpret_mode():
        want = jconv.conv3x3_gemm(jnp.asarray(_nhwc(x)).astype(jdt),
                                  jnp.asarray(_hwio(wt)).astype(jdt),
                                  jnp.asarray(bias) if with_bias else None)
    got = conv.conv3x3_gemm_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
                                  torch.from_numpy(bias) if with_bias else None)
    assert got.dtype == tdt and got.shape == (b, cout, h, w)
    np.testing.assert_allclose(_nhwc(got.float().numpy()), np.asarray(want, np.float32),
                               atol=ATOL[dtype])


def test_gradients_match_jax_custom_vjp():
    """`conv3x3` (kernel forward; dx the kernel on the flipped weights, dw
    and db plain) against jax.grad through the JAX package's custom VJP,
    whose dx runs the Pallas kernel too, fp32."""
    x, wt, bias = _data(2, 128, 8, 8, 128, seed=1)
    g = np.random.default_rng(2).standard_normal((2, 128, 8, 8)).astype(np.float32)

    def loss(x, w, b):
        return jnp.sum(jconv.conv3x3(x, w, b) * jnp.asarray(_nhwc(g)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(_nhwc(x)), jnp.asarray(_hwio(wt)), jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wt, bias)]
    (conv.conv3x3(*ts) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(ts[0].grad.numpy()), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(_hwio(ts[1].grad.numpy()), np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose(ts[2].grad.numpy(), np.asarray(want[2]), atol=1e-3)


def test_dx_is_the_kernel_on_the_flipped_weights(monkeypatch):
    """The backward's dx goes through the kernel's wrapper (so on the card it
    is a launch of the same kernel) and equals autograd of the plain conv;
    dw is not computed for frozen weights."""
    x, wt, bias = (torch.from_numpy(a) for a in _data(1, 16, 8, 8, 24, seed=3))
    calls = []
    real = conv.conv3x3_gemm
    monkeypatch.setattr(conv, "conv3x3_gemm", lambda *a: calls.append(a[1].shape) or real(*a))
    xg = x.clone().requires_grad_()
    conv.conv3x3(xg, wt, bias).square().sum().backward()
    assert calls == [(24, 16, 3, 3), (16, 24, 3, 3)]
    xr = x.clone().requires_grad_()
    F.conv2d(xr, wt, bias, 1, 1).square().sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), xr.grad.numpy(), atol=1e-4)
    assert wt.grad is None


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    conv.conv3x3_gemm.launches = 0
    x, wt, bias = (torch.from_numpy(a) for a in _data(1, 8, 6, 6, 8, seed=4))
    assert torch.equal(conv.conv3x3_gemm(x, wt, bias), conv.conv3x3_gemm_plain(x, wt, bias))
    assert conv.conv3x3_gemm.launches == 0


@pytest.mark.parametrize(
    "dtype,device,want",
    [(torch.bfloat16, "cuda", True), (torch.float32, "cuda", False),
     (torch.float32, "cpu", True)],
)
def test_dispatch_rule(dtype, device, want):
    assert conv.supports(dtype, torch.device(device)) is want


@pytest.mark.parametrize("knob,cin,cout,stride,kernel,routed", [
    ("gemm", 128, 128, 1, 3, True),
    ("gemm", 320, 640, 1, 3, True),
    (None, 128, 128, 1, 3, False),  # the default backend is "xla"
    ("xla", 128, 128, 1, 3, False),
    ("gemm", 4, 320, 1, 3, False),  # conv_in: thin
    ("gemm", 320, 4, 1, 3, False),  # conv_out: thin
    ("gemm", 128, 128, 2, 3, False),  # the downsampler
    ("gemm", 128, 128, 1, 1, False),  # 1x1
])
def test_lora_conv_routes_hot_3x3_convs(knob, cin, cout, stride, kernel, routed, monkeypatch):
    if knob is None:
        monkeypatch.delenv("LECO_CONV_BACKEND", raising=False)
    else:
        monkeypatch.setenv("LECO_CONV_BACKEND", knob)
    calls = []
    real = conv.conv3x3
    monkeypatch.setattr(conv, "conv3x3", lambda *a: calls.append(1) or real(*a))
    layer = lora.LoRAConv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        layer.weight.normal_(generator=gen).mul_(0.05)
        layer.bias.normal_(generator=gen)
        x = torch.randn((1, cin, 8, 8), generator=gen)
        got = layer(x)
        want = F.conv2d(x, layer.weight, layer.bias, stride, kernel // 2)
    assert bool(calls) is routed
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_lora_branch_is_added_after_the_kernel(monkeypatch):
    """c3lier: a hot conv with a LoRA branch takes the kernel for its base
    weights and adds the rank-r branch after, in every mode."""
    monkeypatch.setenv("LECO_CONV_BACKEND", "gemm")
    monkeypatch.setattr(conv, "HOT_MIN_CHANNELS", 8)
    gen = torch.Generator().manual_seed(6)
    layer = lora.LoRAConv2d(8, 16, 3, padding=1)
    with torch.no_grad():
        layer.weight.normal_(generator=gen).mul_(0.1)
        layer.bias.normal_(generator=gen)
    layer.add_lora(lora.LoRASpec(rank=4, alpha=1.0, network_type="c3lier"), gen)
    with torch.no_grad():
        layer.lora_up.normal_(generator=gen)
        x = torch.randn((2, 8, 8, 8), generator=gen)
        got = layer(x)
        monkeypatch.setenv("LECO_CONV_BACKEND", "xla")
        want = layer(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
