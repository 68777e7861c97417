"""The phase-conv upsampler: `LoRAConv2d(pre_upsample=True)` against the JAX
package's `LoRAConv(pre_upsample=True)` (`_phase_conv_up2x`), against the
port's materialised form, and the tiny c3lier UNet in its three LoRA modes
against the JAX UNet, where only the target pass ("on") materialises the
2x upsample, as the JAX package's `lora_active` decides.

Tolerances: fp32 1e-5 (one conv, the same taps summed in another order);
bf16 2^-7 x max|ref| (a bf16 ulp of the largest output: both sides sum the
taps in bf16, then a bf16 conv with fp32 accumulation); the UNet at the
repo's fp32 bound (tests/test_torch_port_unet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from leco_tpu import lora as jax_lora
from leco_tpu.lora import LoRAConv as JaxLoRAConv
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu_torch import lora
from leco_tpu_torch.kernels.time_gates import resnet_convs
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from leco_tpu_torch.ops import conv, geglu, gn_conv
from leco_tpu_torch.ops import group_norm as gn
from leco_tpu_torch.testing import init_unet_
from test_torch_port_unet import port_to_flax

TINY = dict(
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(8, 16),
    layers_per_block=1,
    cross_attention_dim=32,
    attention_head_dim=2,
    norm_num_groups=4,
)
ATOL, RTOL = 2e-4, 1e-3  # the repo's fp32 UNet bound
FP32_TOL = 1e-5
BF16_RTOL = 2.0**-7
KNOBS = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1",
         "LECO_TPU_FUSED_GN": "1", "LECO_GEGLU": "fused"}


def conv_pair(cin, cout, dtype, seed=0):
    """One port pre_upsample conv and the JAX module with its parameters."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32) / np.sqrt(9 * cin)
    b = rng.standard_normal(cout).astype(np.float32)
    port = lora.LoRAConv2d(cin, cout, 3, padding=1, pre_upsample=True)
    port.weight.data = torch.from_numpy(w).to(dtype)
    port.bias.data = torch.from_numpy(b).to(dtype)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmod = JaxLoRAConv(cout, (3, 3), padding=((1, 1), (1, 1)), pre_upsample=True,
                       dtype=jdt, param_dtype=jdt)
    params = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jdt),
              "bias": jnp.asarray(b).astype(jdt)}
    return port, jmod, params


@pytest.mark.parametrize("shape", [(2, 12, 5, 7), (1, 16, 8, 8), (3, 6, 1, 4)])
def test_phase_conv_matches_jax_fp32(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    port, jmod, params = conv_pair(shape[1], 10, torch.float32)
    got = port(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert got.shape == (shape[0], 10, 2 * shape[2], 2 * shape[3])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=FP32_TOL, rtol=FP32_TOL)


def test_phase_conv_matches_the_materialised_form():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 12, 6, 5)).astype(np.float32))
    port, _, _ = conv_pair(12, 9, torch.float32)
    with torch.no_grad():
        want = F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), port.weight,
                        port.bias, 1, 1)
        got = port(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32_TOL, rtol=FP32_TOL)


def test_phase_conv_matches_jax_bf16():
    """bf16 weights and input: both sides sum the taps in bf16 (the JAX
    package after `kernel.astype(self.dtype)`)."""
    x = np.random.default_rng(3).standard_normal((2, 32, 6, 6)).astype(np.float32)
    port, jmod, params = conv_pair(32, 16, torch.bfloat16, seed=4)
    got = port(torch.from_numpy(x).to(torch.bfloat16)).detach().float().numpy()
    want = np.asarray(jmod.apply({"params": params},
                                 jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)),
                      np.float32)
    limit = BF16_RTOL * np.abs(want).max()
    assert np.abs(got.transpose(0, 2, 3, 1) - want).max() <= limit


def test_pre_upsample_needs_a_3x3_stride_1_conv():
    with pytest.raises(ValueError, match="pre_upsample"):
        lora.LoRAConv2d(4, 4, 1, pre_upsample=True)


@pytest.fixture(scope="module")
def c3lier():
    """The tiny UNet with c3lier LoRA on both sides, on one set of perturbed
    weights (lora_up non-zero)."""
    rng = np.random.default_rng(0)
    port = UNet2DConditionModel(UNetConfig(**TINY))
    gen = torch.Generator().manual_seed(0)
    init_unet_(port, gen, torch.float32)
    spec_args = dict(rank=4, alpha=1.0, network_type="c3lier")
    lora.apply_lora_spec(port, lora.LoRASpec(**spec_args), gen)
    state = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in port.state_dict().items()}
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = port_to_flax(state)
    spec = jax_lora.LoRASpec(**spec_args)
    base, tree = jax_lora.split_lora_params(params)
    return dict(port=port, unet=JaxUNet(config=JaxUNetConfig(**TINY), lora_spec=spec),
                trees={"on": params, "off": base,
                       "folded": jax_lora.fold_lora_params(base, tree, spec)},
                inputs=(rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                        np.array([501.0, 33.0], np.float32),
                        rng.standard_normal((2, 77, 32)).astype(np.float32)))


@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_c3lier_unet_modes_match_jax(c3lier, mode, monkeypatch):
    sample, timesteps, ctx = c3lier["inputs"]
    want = np.asarray(jax.jit(c3lier["unet"].apply)(
        {"params": jax.tree.map(jnp.asarray, c3lier["trees"][mode])},
        jnp.asarray(sample), jnp.asarray(timesteps), jnp.asarray(ctx)))
    phases = []
    real = lora.LoRAConv2d._phase_conv_up2x
    monkeypatch.setattr(lora.LoRAConv2d, "_phase_conv_up2x",
                        lambda self, *a: phases.append(1) or real(self, *a))
    port = c3lier["port"]
    ctxm = lora.folded_lora(port) if mode == "folded" else lora.lora_mode(port, mode)
    with torch.no_grad(), ctxm:
        got = port(torch.from_numpy(sample.transpose(0, 3, 1, 2)), torch.from_numpy(timesteps),
                   torch.from_numpy(ctx)).numpy()
    # the one upsampler: materialised with its branch on, phase convs else
    assert len(phases) == (0 if mode == "on" else 1)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=ATOL, rtol=RTOL)


def _count_plain_calls(monkeypatch) -> dict:
    calls = {}
    for name, mod, fn in (("conv3x3", conv, "conv3x3_gemm_plain"),
                          ("gnconv3x3", gn_conv, "gnconv3x3_plain"),
                          ("group_norm", gn, "group_norm_silu_plain"),
                          ("geglu", geglu, "geglu_gemm_plain")):
        real = getattr(mod, fn)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    return calls


def conv_counts(convs, gate) -> tuple[int, int, int]:
    """`chip_smoke.fused_launches`'s `convs`: the traced resnet convs
    (`resnet_convs`) through gnconv3x3, refused by `gate`, refused with dx."""
    refused = [c for c in convs if not gate(c)]
    return len(convs) - len(refused), len(refused), sum(bool(c[4]) for c in refused)


@pytest.mark.parametrize("network", ["lierla", "c3lier"])
def test_fused_schedule_of_chip_smoke(network, monkeypatch):
    """chip_smoke's `fused_launches` against the calls of each kernel's
    plain version in the tiny UNet with every knob on (8 resnets, 1
    upsampler, 4 transformer blocks; the conv gate at 5 channels, so that
    conv_in and conv_out stay thin as in SD): a folded, an off and an on
    forward, then the on forward's backward."""
    convs = resnet_convs(UNetConfig(**TINY), 64, 64)
    assert len(convs) == 16  # 8 resnets
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(gn_conv, "supports", lambda *a: True)
    monkeypatch.setattr(conv, "HOT_MIN_CHANNELS", 5)
    unet = UNet2DConditionModel(UNetConfig(**TINY), attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(unet, gen, torch.float32)
    lora.apply_lora_spec(unet, lora.LoRASpec(rank=4, network_type=network), gen)
    x = torch.randn((1, 4, 8, 8), generator=gen)
    ctx = torch.randn((1, 77, 32), generator=gen)
    calls = _count_plain_calls(monkeypatch)
    with torch.no_grad():
        with lora.folded_lora(unet):
            unet(x, 10.0, ctx)
        with lora.lora_mode(unet, "off"):
            unet(x, 10.0, ctx)
    out = unet(x, 10.0, ctx)
    out.float().square().mean().backward()
    assert calls == chip_smoke.fused_launches(network, forwards=3, targets=1,
                                              convs=conv_counts(convs, lambda c: True),
                                              upsamplers=1, transformers=4)


def test_fused_schedule_of_chip_smoke_with_refused_convs(monkeypatch):
    """The same, lierla, with the gnconv gate refusing the level-0 resnet
    convs (8 x 8 here, as `gn_conv.MAX_FUSED_SIDE` refuses SD's 32 x 32
    and 64 x 64 ones): those take the GroupNorm kernel and conv3x3, and the backward
    runs conv3x3's dx where the conv's input needs a gradient (not the
    first resnet's, before any LoRA)."""
    convs = resnet_convs(UNetConfig(**TINY), 64, 64)
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(gn_conv, "supports", lambda shape, cout, dtype, device: shape[2] != 8)
    monkeypatch.setattr(conv, "HOT_MIN_CHANNELS", 5)
    unet = UNet2DConditionModel(UNetConfig(**TINY), attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(unet, gen, torch.float32)
    lora.apply_lora_spec(unet, lora.LoRASpec(rank=4, network_type="lierla"), gen)
    x = torch.randn((1, 4, 8, 8), generator=gen)
    ctx = torch.randn((1, 77, 32), generator=gen)
    calls = _count_plain_calls(monkeypatch)
    with torch.no_grad():
        with lora.folded_lora(unet):
            unet(x, 10.0, ctx)
        with lora.lora_mode(unet, "off"):
            unet(x, 10.0, ctx)
    unet(x, 10.0, ctx).float().square().mean().backward()
    want = chip_smoke.fused_launches("lierla", forwards=3, targets=1,
                                     convs=conv_counts(convs, lambda c: c[1] != 8),
                                     upsamplers=1, transformers=4)
    assert want["conv3x3"] > 0 and want["gnconv3x3"] > 0  # both routes run
    assert calls == want


@pytest.mark.parametrize("model,resolution,pinned", [
    ("sd15", chip_smoke.SD15_RESOLUTION, chip_smoke.SD15_CONVS),
    ("sdxl", chip_smoke.XL_RESOLUTION, chip_smoke.XL_CONVS),
])
def test_pinned_conv_counts_of_chip_smoke_follow_the_gate(model, resolution, pinned):
    """chip_smoke pins the knobs-on resnet conv counts its launch checks
    expect; they are the port's gnconv gate on the model's traced convs."""
    gate = lambda c: gn_conv.supports((1, c[0], c[1], c[2]), c[3], torch.bfloat16,  # noqa: E731
                                      torch.device("cuda"))
    assert conv_counts(chip_smoke.unet_convs(model, resolution), gate) == pinned
    assert len(chip_smoke.refused_convs(model, resolution)) == pinned[1]
