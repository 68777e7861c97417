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
    is a launch of the same kernel, the flip folded into its weight repack)
    and equals autograd of the plain conv; dw is not computed for frozen
    weights."""
    x, wt, bias = (torch.from_numpy(a) for a in _data(1, 16, 8, 8, 24, seed=3))
    calls = []
    real = conv.conv3x3_gemm
    monkeypatch.setattr(conv, "conv3x3_gemm", lambda *a, **k: calls.append(
        (tuple(a[1].shape), k.get("flip", False))) or real(*a, **k))
    xg = x.clone().requires_grad_()
    conv.conv3x3(xg, wt, bias).square().sum().backward()
    assert calls == [((24, 16, 3, 3), False), ((24, 16, 3, 3), True)]
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


@pytest.mark.parametrize("cin,cout", [(16, 24), (20, 24), (320, 320), (192, 320)])
def test_weight_repack_is_the_jax_tap_layout_transposed(cin, cout):
    """`pack_weight_plain` (what the kernel reads, and what its CUDA repack is
    held to on the card) is the JAX kernel's `kernel.reshape(9, cin, cout)`
    (conv.py:101) of the HWIO weights, transposed to (9, Cout, Cin), with
    zeros past Cin to a multiple of 8; flipped, the same of the backward's
    `k_flip` (conv.py:166)."""
    _, wt, _ = _data(1, cin, 4, 4, cout, seed=5)
    hwio = jnp.asarray(_hwio(wt))
    want = np.asarray(hwio.reshape(9, cin, cout)).transpose(0, 2, 1)
    k_flip = jnp.flip(hwio, axis=(0, 1)).transpose(0, 1, 3, 2)
    want_flip = np.asarray(k_flip.reshape(9, cout, cin)).transpose(0, 2, 1)
    for flip, ref, cols in ((False, want, cin), (True, want_flip, cout)):
        got = conv.pack_weight(torch.from_numpy(wt), flip).numpy()
        assert got.shape == (9, ref.shape[1], -(-cols // 8) * 8)
        np.testing.assert_array_equal(got[:, :, :cols], ref)
        assert not got[:, :, cols:].any()


# every conv shape of the SD1.5 UNet at 512 px (batch 2; the resnet convs
# and the upsamplers), SD2.1's 768 px levels (96, 48, 24, 12), 1024 px's
# 128, and the gate's smallest image: (B, Cin, H, W, Cout), then the route,
# the tile width, the pixel tiles of an image and the K split
@pytest.mark.parametrize("b,cin,h,w,cout,route,wb,tiles,splits", [
    (2, 320, 64, 64, 320, "tma", 64, 32, 1), (2, 960, 64, 64, 320, "tma", 64, 32, 1),
    (2, 640, 64, 64, 640, "tma", 64, 32, 1), (2, 640, 32, 32, 640, "tma", 32, 8, 1),
    (2, 1920, 32, 32, 640, "tma", 32, 8, 1), (2, 1280, 32, 32, 1280, "tma", 32, 8, 1),
    (2, 640, 16, 16, 1280, "tma", 16, 2, 3), (2, 2560, 16, 16, 1280, "tma", 16, 2, 3),
    (2, 1280, 8, 8, 1280, "tma", 16, 1, 5), (2, 2560, 8, 8, 1280, "tma", 16, 1, 6),
    (4, 320, 96, 96, 320, "tma", 64, 96, 1), (4, 640, 48, 48, 640, "tma", 64, 24, 1),
    (4, 1280, 24, 24, 1280, "tma", 32, 6, 1), (4, 1280, 12, 12, 1280, "fill", 16, 2, 1),
    (1, 320, 128, 128, 320, "tma", 64, 128, 1), (1, 128, 4, 4, 128, "fill", 16, 1, 2),
])
def test_tile_plan_at_every_sd_shape(b, cin, h, w, cout, route, wb, tiles, splits):
    plan = conv.tile_plan(b, cin, h, w, cout)
    assert (plan["route"], plan["wb"], plan["pixel_tiles_per_image"], plan["splits"]) == (
        route, wb, tiles, splits)
    assert plan["rows"] * plan["wb"] == 128 and plan["swizzle"] == 2 * wb
    assert plan["wb"] >= min(w, 64) or w % 8  # one tile spans the row, or 64 columns of it
    per = -(-plan["chunks"] // plan["splits"])  # every split gets at least one chunk
    assert (plan["splits"] - 1) * per < plan["chunks"] <= plan["splits"] * per
