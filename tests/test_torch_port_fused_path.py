"""The slice as a whole: the JAX package's fused-kernel configuration
(`LECO_CONV_BACKEND=gemm`, `LECO_RESNET_FUSED=1`, `LECO_TPU_FUSED_GN=1`,
`LECO_GEGLU=fused`) on both sides, the port's UNet against the JAX package's
on shared weights (tests/test_torch_port_fused_train_step.py: the train
step).

The tiny UNet is 8 and 16 channels wide, under the 128-channel shape gates of
the fused resnet and the 3x3 conv kernel, so both sides force the gates open
as tests/test_gn_conv.py::TestResnetIntegration does; the JAX package runs its
Pallas kernels in interpret mode and with `LECO_LORA_FUSE=0` (the port has no
ride-along). The JAX package reads the knobs when it traces, so its functions
are built after they are set. Inside its UNet on the CPU the JAX package never
reaches `_gn_kernel` (group_norm.py:326-330 asks for a TPU), so here the port's
GroupNorm kernel's plain version is held to `group_norm_silu_ref`;
tests/test_torch_port_group_norm.py holds it to `_gn_kernel`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu import lora as jax_lora
from leco_tpu.ops import gn_conv as jgc
from leco_tpu_torch import lora
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from leco_tpu_torch.ops import conv, geglu, gn_conv
from leco_tpu_torch.ops import group_norm as gn
from leco_tpu_torch.testing import init_unet_
from test_torch_port_unet import port_to_flax

KNOBS = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1",
         "LECO_TPU_FUSED_GN": "1", "LECO_GEGLU": "fused"}
TINY = dict(
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(8, 16),
    layers_per_block=1,
    cross_attention_dim=32,
    attention_head_dim=2,
    norm_num_groups=4,
)
# the fp32 UNet bound of tests/test_torch_port_unet.py
ATOL, RTOL = 2e-4, 1e-3


def _jax_hot_3x3(self, in_features):
    """The JAX LoRAConv._is_hot_3x3 without its 128-channel floor."""
    if isinstance(self.padding, str):
        return False
    return (tuple(self.kernel_size) == (3, 3) and tuple(self.strides) == (1, 1)
            and tuple(map(tuple, self.padding)) == ((1, 1), (1, 1)) and self.use_bias)


@pytest.fixture
def knobs(monkeypatch):
    """All four knobs on, both sides; the shape gates forced open."""
    from leco_tpu.lora import LoRAConv as JaxLoRAConv

    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LECO_LORA_FUSE", "0")
    monkeypatch.setenv("LECO_GNCONV_INTERPRET", "1")
    monkeypatch.setattr(jgc, "supports", lambda shape, cout, dtype: True)
    monkeypatch.setattr(JaxLoRAConv, "_is_hot_3x3", _jax_hot_3x3)
    monkeypatch.setattr(gn_conv, "supports", lambda *a: True)
    monkeypatch.setattr(conv, "HOT_MIN_CHANNELS", 1)


def _count_plain_calls(monkeypatch) -> dict:
    """Count the calls of each kernel's plain version (what a kernel wrapper
    runs on the CPU)."""
    calls = {}
    for mod, name in ((conv, "conv3x3_gemm_plain"), (gn_conv, "gnconv3x3_plain"),
                      (gn, "group_norm_silu_plain"), (geglu, "geglu_gemm_plain")):
        real = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.fixture(scope="module")
def models():
    """Both UNets on one set of perturbed weights (LoRA leaves non-zero)."""
    rng = np.random.default_rng(0)
    port = UNet2DConditionModel(UNetConfig(**TINY), attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(port, gen, torch.float32)
    spec_args = dict(rank=4, alpha=1.0)
    lora.apply_lora_spec(port, lora.LoRASpec(**spec_args), gen)
    state = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in port.state_dict().items()}
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = port_to_flax(state)
    spec = jax_lora.LoRASpec(**spec_args)
    base, lora_tree = jax_lora.split_lora_params(params)
    from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
    from leco_tpu.models.unet import UNetConfig as JaxUNetConfig

    return dict(
        port=port, state=state,
        unet=JaxUNet(config=JaxUNetConfig(**TINY), lora_spec=spec),
        trees={"on": params, "off": base,
               "folded": jax_lora.fold_lora_params(base, lora_tree, spec)},
        inputs=(rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
                np.array([501.0, 33.0], np.float32),
                rng.standard_normal((2, 77, 32)).astype(np.float32)),
    )


@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_fused_forward_matches_jax_fused_forward(models, mode, knobs, monkeypatch):
    """One fp32 forward per LoRA mode with the knobs on: 2 convs in each of
    the 8 resnets through the fused resnet, conv_in and conv_out through the
    conv kernel (the upsampler, with no LoRA branch, runs its phase
    convolutions on both sides), the 4 transformer norms and conv_norm_out
    through the GroupNorm kernel and the 4 GEGLUs through the GEGLU kernel,
    each as its plain version."""
    sample, timesteps, ctx = models["inputs"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(models["unet"].apply)(
            {"params": jax.tree.map(jnp.asarray, models["trees"][mode])},
            jnp.asarray(sample), jnp.asarray(timesteps), jnp.asarray(ctx)))
    calls = _count_plain_calls(monkeypatch)
    port = models["port"]
    ctxm = lora.folded_lora(port) if mode == "folded" else lora.lora_mode(port, mode)
    with torch.no_grad(), ctxm:
        got = port(torch.from_numpy(sample.transpose(0, 3, 1, 2)),
                   torch.from_numpy(timesteps), torch.from_numpy(ctx)).numpy()
    assert calls == {"conv3x3_gemm_plain": 2, "gnconv3x3_plain": 16,
                     "group_norm_silu_plain": 5, "geglu_gemm_plain": 4}
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=ATOL, rtol=RTOL)


def test_knobs_on_matches_knobs_off(models, knobs, monkeypatch):
    """The port's own fused path against its default path, fp32."""
    sample, timesteps, ctx = (torch.from_numpy(a) for a in models["inputs"])
    port = models["port"]
    with torch.no_grad():
        got = port(sample.permute(0, 3, 1, 2), timesteps, ctx)
        for k in KNOBS:
            monkeypatch.delenv(k)
        want = port(sample.permute(0, 3, 1, 2), timesteps, ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_state_dict_keys_do_not_depend_on_the_knobs(monkeypatch):
    def keys():
        unet = UNet2DConditionModel(UNetConfig(**TINY))
        lora.apply_lora_spec(unet, lora.LoRASpec(rank=4, alpha=1.0), torch.Generator())
        return {k: tuple(v.shape) for k, v in unet.state_dict().items()}

    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    off = keys()
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    assert keys() == off
