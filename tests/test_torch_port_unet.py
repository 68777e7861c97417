"""The port's UNet against the JAX package's UNet, with shared weights.

One fp32 forward of a small SD1.5-shaped UNet (the `sd15_shaped` widths of
tests/test_torch_unet_fullgraph.py). The weights are made once, every leaf
perturbed off its init from a numpy seed (GN/LN at 1/0 and lora_up at 0 would
hide mapping mistakes), LoRA leaves included and non-zero. The JAX tree comes
from them through the JAX package's own `torch_unet_to_flax` (plus the LoRA
transposes), and `leco_tpu_torch.models.convert.flax_unet_to_torch` must
carry that tree back to the port's state_dict exactly. A 16x16 latent gives
level 0 256 tokens, so the port's flash route runs (its kernels' plain
versions on the CPU). The three LoRA modes are held to the JAX package's
three parameter trees: merged (on), base only (off) and `fold_lora_params`
(folded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from leco_tpu import lora as jax_lora
from leco_tpu.models.convert import _fold_path, torch_unet_to_flax
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu_torch import lora
from leco_tpu_torch.models.convert import flax_unet_to_torch
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.testing import init_unet_

WIDTHS = dict(
    block_out_channels=(8, 16, 16, 32),
    layers_per_block=2,
    cross_attention_dim=16,
    attention_head_dim=2,
    use_linear_projection=False,
    norm_num_groups=4,
)
SPEC_ARGS = dict(rank=4, alpha=1.0)
# the repo's own fp32 SD1.5 full-graph bound (test_torch_unet_fullgraph.py)
ATOL, RTOL = 2e-4, 1e-3


def port_to_flax(state: dict) -> dict:
    """The port's state_dict (numpy) -> the JAX package's parameter tree."""
    base = {k: v for k, v in state.items() if ".lora_" not in k}
    flat = flatten_dict(torch_unet_to_flax(base))
    for k, v in state.items():
        if ".lora_" in k:
            layer, leaf = k.rsplit(".", 1)
            if leaf == "lora_down":  # (r, in) / (r, in, kh, kw)
                v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
            else:  # (out, r) / (out, r, 1, 1)
                v = v.T if v.ndim == 2 else v[:, :, 0, 0].T
            flat[_fold_path(layer) + (leaf,)] = v
    return unflatten_dict(flat)


def build(spec_args: dict, seed: int = 0) -> dict:
    """Both models on one set of weights, with the JAX trees of each mode."""
    rng = np.random.default_rng(seed)
    port = UNet2DConditionModel(UNetConfig(**WIDTHS), attn_backend="flash")
    gen = torch.Generator().manual_seed(seed)
    init_unet_(port, gen, torch.float32)
    lora.apply_lora_spec(port, lora.LoRASpec(**spec_args), gen)
    state = {
        k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        for k, v in port.state_dict().items()
    }
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})

    params = port_to_flax(state)
    spec = jax_lora.LoRASpec(**spec_args)
    base, lora_tree = jax_lora.split_lora_params(params)
    trees = {
        "on": params,
        "off": base,
        "folded": jax_lora.fold_lora_params(base, lora_tree, spec),
    }
    unet = JaxUNet(config=JaxUNetConfig(**WIDTHS), lora_spec=spec)
    sample = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    timesteps = np.array([501.0, 33.0], np.float32)
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    return dict(unet=unet, trees=trees, port=port, state=state,
                inputs=(sample, timesteps, ctx))


def forward_both(models: dict, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(port output, JAX output), NHWC, for one LoRA mode."""
    sample, timesteps, ctx = models["inputs"]
    want = np.asarray(
        jax.jit(models["unet"].apply)(
            {"params": jax.tree.map(jnp.asarray, models["trees"][mode])},
            jnp.asarray(sample), jnp.asarray(timesteps), jnp.asarray(ctx),
        )
    )
    port = models["port"]
    ctxm = lora.folded_lora(port) if mode == "folded" else lora.lora_mode(port, mode)
    with torch.no_grad(), ctxm:
        got = port(
            torch.from_numpy(sample.transpose(0, 3, 1, 2)),
            torch.from_numpy(timesteps),
            torch.from_numpy(ctx),
        ).numpy().transpose(0, 2, 3, 1)
    return got, want


@pytest.fixture(scope="module")
def shared():
    return build(SPEC_ARGS)


def test_flax_unet_to_torch_carries_the_tree_back(shared):
    back = flax_unet_to_torch(shared["trees"]["on"])
    assert set(back) == set(shared["state"])
    for k, v in shared["state"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # and a fresh port model takes it as is
    fresh = UNet2DConditionModel(UNetConfig(**WIDTHS))
    lora.apply_lora_spec(fresh, lora.LoRASpec(**SPEC_ARGS), torch.Generator())
    fresh.load_state_dict(back, strict=True)


def test_jax_tree_has_the_jax_model_structure(shared):
    """The converted tree is exactly what the JAX UNet would initialize."""
    sample, timesteps, ctx = shared["inputs"]
    init = jax.eval_shape(
        shared["unet"].init, jax.random.PRNGKey(0), jnp.asarray(sample),
        jnp.asarray(timesteps), jnp.asarray(ctx),
    )["params"]
    want = {k: v.shape for k, v in flatten_dict(init).items()}
    got = {k: v.shape for k, v in flatten_dict(shared["trees"]["on"]).items()}
    assert got == want


@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_forward_matches_jax(shared, mode, monkeypatch):
    calls = []
    real = fa.attn_fwd_plain
    monkeypatch.setattr(fa, "attn_fwd_plain", lambda *a: calls.append(a[0].shape) or real(*a))
    got, want = forward_both(shared, mode)
    # level 0 of the down path (2 blocks) and of the up path (3 blocks) take
    # the flash route: (B * heads, 256 tokens, head dim 4)
    assert calls == [(4, 256, 4)] * 5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_c3lier_conv_lora_matches_jax():
    """c3lier puts LoRA on the resnet, down- and upsampler 3x3 convs too;
    rank 16 is clamped to the 8 channels of level 0's convs (lora.py:72)."""
    models = build(dict(rank=16, alpha=1.0, network_type="c3lier"), seed=1)
    down = models["state"]["down_blocks.0.resnets.0.conv1.lora_down"]
    assert down.shape == (8, 8, 3, 3)
    got, want = forward_both(models, "on")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fold_lora_params_matches_jax(shared):
    """The state-dict fold against the JAX package's pytree fold."""
    state = {k: torch.from_numpy(v) for k, v in shared["state"].items()}
    base, lora_sd = lora.split_lora_params(state)
    assert lora.merge_params(base, lora_sd).keys() == state.keys()
    got = lora.fold_lora_params(base, lora_sd, lora.LoRASpec(**SPEC_ARGS))
    want = flax_unet_to_torch(shared["trees"]["folded"])
    assert got.keys() == want.keys() == base.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("network_type", ["lierla", "c3lier"])
@pytest.mark.parametrize("method", ["full", "noxattn", "innoxattn", "selfattn", "xattn"])
def test_lora_spec_matches_jax(shared, network_type, method):
    """The targeting rule on dotted names equals the JAX rule on flax paths
    for every layer of the UNet."""
    port_spec = lora.LoRASpec(4, 1.0, network_type, method)
    jax_spec = jax_lora.LoRASpec(4, 1.0, network_type, method)
    names = [n for n, m in shared["port"].named_modules()
             if isinstance(m, (lora.LoRALinear, lora.LoRAConv2d))]
    got = [port_spec.matches(n) for n in names]
    assert got == [jax_spec.matches(_fold_path(n)) for n in names]
    assert any(got)
