"""The port's GroupNorm(+SiLU) (leco_tpu_torch/ops/group_norm.py) against the
JAX package's.

The JAX kernel `_gn_kernel` runs in interpret mode on the CPU, as
tests/test_group_norm.py runs it; the port's side runs the kernel's plain
version. The port is NCHW, the JAX package NHWC: inputs come from a numpy
seed and are transposed at the boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops import group_norm as jgn
from leco_tpu_torch.models.unet import GroupNorm
from leco_tpu_torch.ops import group_norm as gn

# fp32: summation order only; bf16: the bound of tests/test_group_norm.py
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(shape, seed=0):
    """x (B, C, H, W) with a channel-dependent mean, scale and bias (C)."""
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    x = rng.standard_normal(shape).astype(np.float32) + rng.standard_normal((1, c, 1, 1)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _nhwc(x):
    return x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 16, 8, 8), 4, 1e-5, True),
    ((2, 16, 8, 8), 4, 1e-6, False),
    ((1, 64, 16, 8), 32, 1e-6, False),
    ((3, 40, 4, 4), 4, 1e-5, True),
])
def test_kernel_plain_matches_jax_kernel(shape, groups, eps, silu, dtype):
    jdt, tdt = DTYPES[dtype]
    x, scale, bias = _data(shape)
    with pltpu.force_tpu_interpret_mode():
        want = jgn.group_norm_silu(jnp.asarray(_nhwc(x)).astype(jdt), jnp.asarray(scale),
                                   jnp.asarray(bias), groups, eps, silu)
    got = gn.group_norm_silu_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                                   torch.from_numpy(bias), groups, eps, silu)
    assert got.dtype == tdt
    np.testing.assert_allclose(_nhwc(got.float().numpy()), np.asarray(want, np.float32),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("silu", [False, True])
def test_reference_matches_jax_reference(silu):
    x, scale, bias = _data((2, 16, 8, 8), seed=1)
    want = jgn.group_norm_silu_ref(jnp.asarray(_nhwc(x)), jnp.asarray(scale),
                                   jnp.asarray(bias), 4, 1e-5, silu)
    got = gn.group_norm_silu_ref(*map(torch.from_numpy, (x, scale, bias)), 4, 1e-5, silu)
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), atol=1e-5)


def test_gradients_match_jax_custom_vjp():
    """fused_group_norm (kernel forward, reference backward) against jax.grad
    through the JAX package's custom VJP, fp32, for x, scale and bias."""
    x, scale, bias = _data((2, 16, 8, 8), seed=2)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def loss(x, s, b):
        return jnp.sum(jgn.fused_group_norm(x, s, b, 4, 1e-5, True) * jnp.asarray(_nhwc(g)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    (gn.fused_group_norm(*ts, 4, 1e-5, True) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(ts[0].grad.numpy()), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(ts[1].grad.numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(ts[2].grad.numpy(), np.asarray(want[2]), atol=1e-4)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    gn.group_norm_silu.launches = 0
    args = [torch.from_numpy(a) for a in _data((2, 16, 4, 4), seed=4)]
    assert torch.equal(gn.group_norm_silu(*args, 4, 1e-5, True),
                       gn.group_norm_silu_plain(*args, 4, 1e-5, True))
    assert gn.group_norm_silu.launches == 0


@pytest.mark.parametrize(
    "dtype,device,want",
    [(torch.bfloat16, "cuda", True), (torch.float32, "cuda", False),
     (torch.float32, "cpu", True)],
)
def test_dispatch_rule(dtype, device, want):
    assert gn.supports(dtype, torch.device(device)) is want


@pytest.mark.parametrize("knob,fused", [(None, False), ("0", False), ("1", True)])
def test_unet_group_norm_takes_the_kernel_path_under_the_knob(knob, fused, monkeypatch):
    """`LECO_TPU_FUSED_GN=1`, read at call time, sends the UNet's GroupNorm
    through `fused_group_norm`; both paths give the same GroupNorm."""
    if knob is None:
        monkeypatch.delenv("LECO_TPU_FUSED_GN", raising=False)
    else:
        monkeypatch.setenv("LECO_TPU_FUSED_GN", knob)
    calls = []
    real = gn.fused_group_norm
    monkeypatch.setattr(gn, "fused_group_norm", lambda *a: calls.append(a[3:]) or real(*a))
    x, scale, bias = _data((2, 16, 8, 8), seed=5)
    mod = GroupNorm(4, 16, 1e-6, silu=True)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x))
    assert calls == ([(4, 1e-6, True)] if fused else [])
    want = gn.group_norm_silu_ref(*map(torch.from_numpy, (x, scale, bias)), 4, 1e-6, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
