"""A narrow SD2.1-shaped UNet against the JAX package's, with shared
weights: linear projections, per-level head counts with every head the same
width (as SD2.1's 64), the fp32 softmax upcast, LoRA on, off and folded.
The weights, trees and inputs are built as in test_torch_port_unet.py. A
16x16 latent gives level 0 256 tokens: the port's flash route (the kernels'
plain versions on the CPU) runs there, the 3-d one by default and the packed
one under LECO_FLASH_PACKED=1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu import lora as jax_lora
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu.models.unet import sd21_config as jax_sd21_config
from leco_tpu_torch import lora
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig, sd21_config
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.testing import init_unet_
from tests.test_torch_port_unet import port_to_flax

WIDTHS = dict(
    block_out_channels=(8, 16, 16, 32),
    layers_per_block=2,
    cross_attention_dim=16,
    attention_head_dim=(2, 4, 4, 8),  # every head 4 wide
    use_linear_projection=True,
    upcast_attention=True,
    norm_num_groups=4,
)
SPEC = dict(rank=4, alpha=1.0)
ATOL, RTOL = 2e-4, 1e-3  # the repo's fp32 SD1.5 full-graph bound


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    port = UNet2DConditionModel(UNetConfig(**WIDTHS), attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(port, gen, torch.float32)
    lora.apply_lora_spec(port, lora.LoRASpec(**SPEC), gen)
    state = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in port.state_dict().items()}
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = port_to_flax(state)
    spec = jax_lora.LoRASpec(**SPEC)
    base, lora_tree = jax_lora.split_lora_params(params)
    trees = {"on": params, "off": base,
             "folded": jax_lora.fold_lora_params(base, lora_tree, spec)}
    inputs = (rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
              np.array([501.0, 33.0], np.float32),
              rng.standard_normal((2, 77, 16)).astype(np.float32))
    return dict(unet=JaxUNet(config=JaxUNetConfig(**WIDTHS), lora_spec=spec), trees=trees,
                port=port, inputs=inputs, jax_out={})


def _forward_both(models, mode):
    sample, t, ctx = models["inputs"]
    if mode not in models["jax_out"]:  # one JAX forward per mode, for both routes
        models["jax_out"][mode] = np.asarray(jax.jit(models["unet"].apply)(
            {"params": jax.tree.map(jnp.asarray, models["trees"][mode])},
            jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)))
    want = models["jax_out"][mode]
    port = models["port"]
    ctxm = lora.folded_lora(port) if mode == "folded" else lora.lora_mode(port, mode)
    with torch.no_grad(), ctxm:
        got = port(torch.from_numpy(sample.transpose(0, 3, 1, 2)), torch.from_numpy(t),
                   torch.from_numpy(ctx)).numpy().transpose(0, 2, 3, 1)
    return got, want


def test_sd21_config_matches_jax():
    assert UNetConfig(**{f: getattr(jax_sd21_config(), f) for f in UNetConfig.__dataclass_fields__}) \
        == sd21_config()
    assert {c // h for c, h in zip(sd21_config().block_out_channels,
                                   sd21_config().heads_per_block)} == {64}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_forward_matches_jax(shared, mode, packed, monkeypatch):
    if packed:
        monkeypatch.setenv("LECO_FLASH_PACKED", "1")
    else:
        monkeypatch.delenv("LECO_FLASH_PACKED", raising=False)
    calls = {"3d": [], "packed": []}
    real_3d, real_packed = fa.attn_fwd_plain, fa.attn_fwd_packed_plain
    monkeypatch.setattr(fa, "attn_fwd_plain", lambda *a: calls["3d"].append(a[0].shape) or real_3d(*a))
    monkeypatch.setattr(fa, "attn_fwd_packed_plain",
                        lambda *a: calls["packed"].append(a[0].shape) or real_packed(*a))
    got, want = _forward_both(shared, mode)
    # level 0: 2 down + 3 up self-attentions over 256 tokens, 2 heads of 4
    if packed:
        assert calls == {"3d": [], "packed": [(2, 256, 8)] * 5}
    else:
        assert calls == {"3d": [(4, 256, 4)] * 5, "packed": []}
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
