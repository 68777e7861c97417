"""The port's LoRA tree operations and AddNet files against the JAX package's.

One tiny c3lier UNet (LoRA on the dense and the conv layers, the conv rank
clamped) gives the port's tree; every leaf is perturbed off its init from a
numpy seed, and the JAX tree is the same numbers in the flax layout.
`scale_lora_tree` and `compose_lora_params` are held to the JAX functions
in fp32 (atol 1e-6: the same fp32 operations, summed in another order);
files go both ways between `save_lora_weights` and `load_lora_weights` and
read back exactly (fp32 files)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from leco_tpu import lora as jax_lora
from leco_tpu.models.convert import _fold_path
from leco_tpu_torch import lora
from leco_tpu_torch.models.unet import UNet2DConditionModel, tiny_unet_config
from leco_tpu_torch.testing import init_unet_

SPEC_ARGS = dict(rank=4, alpha=1.0, network_type="c3lier")
ATOL = 1e-6


def to_flax(tree: dict) -> dict:
    """A port tree (torch layout) -> the JAX package's LoRA tree."""
    flat = {}
    for k, v in tree.items():
        layer, leaf = k.rsplit(".", 1)
        v = np.asarray(v, np.float32)
        if leaf == "lora_down":  # (r, in) / (r, in, kh, kw)
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        else:  # (out, r) / (out, r, 1, 1)
            v = v.T if v.ndim == 2 else v[:, :, 0, 0].T
        flat[_fold_path(layer) + (leaf,)] = jnp.asarray(v)
    return unflatten_dict(flat)


def weights_to_flax(base: dict) -> dict:
    """{"<layer>.weight": t} -> the JAX package's {path: {"kernel": ...}}."""
    flat = {}
    for k, v in base.items():
        v = np.asarray(v, np.float32)
        flat[_fold_path(k.rsplit(".", 1)[0]) + ("kernel",)] = jnp.asarray(
            v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0))
    return unflatten_dict(flat)


def assert_trees_equal(port: dict, flax: dict, atol: float = ATOL) -> None:
    want = flatten_dict(to_flax(port))
    got = flatten_dict(flax)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol,
                                   err_msg=str(k))


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    unet = UNet2DConditionModel(tiny_unet_config())
    gen = torch.Generator().manual_seed(0)
    init_unet_(unet, gen, torch.float32)
    lora.apply_lora_spec(unet, lora.LoRASpec(**SPEC_ARGS), gen)
    ref = lora.lora_parameters(unet)

    def draw(scale):
        return {k: torch.from_numpy((scale * rng.standard_normal(v.shape)).astype(np.float32))
                for k, v in ref.items()}

    layers = sorted({k.rsplit(".", 1)[0] for k in ref})
    base = {f"{n}.weight": dict(unet.named_modules())[n].weight.detach().clone()
            for n in layers}
    return dict(ref={k: v.detach() for k, v in ref.items()}, a=draw(0.1), b=draw(0.05),
                base=base)


def test_tree_has_dense_and_clamped_conv_layers(trees):
    ref = trees["ref"]
    assert ref["down_blocks.0.resnets.0.conv1.lora_down"].shape == (4, 8, 3, 3)
    assert ref["up_blocks.0.upsamplers.0.conv.lora_up"].shape == (16, 4, 1, 1)
    assert ref["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.lora_down"].ndim == 2


@pytest.mark.parametrize("multiplier", [-1.0, 0.0, 0.7])
def test_scale_lora_tree_matches_jax(trees, multiplier):
    got = lora.scale_lora_tree(trees["a"], multiplier)
    assert got.keys() == trees["a"].keys()
    for k, v in got.items():  # lora_down untouched
        if k.endswith(".lora_down"):
            assert v is trees["a"][k]
    assert_trees_equal(got, jax_lora.scale_lora_tree(to_flax(trees["a"]), multiplier))


@pytest.mark.parametrize("pairs", [((0.5, "a"), (-1.0, "b")), ((1.0, "a"), (0.0, "b"), (0.25, "a"))])
def test_compose_lora_params_matches_jax(trees, pairs):
    """Sequential folds, multiplier 0 skipped, against the JAX fold."""
    spec_args = dict(SPEC_ARGS)
    got = lora.compose_lora_params(trees["base"], [(trees[t], m) for m, t in pairs],
                                   lora.LoRASpec(**spec_args))
    want = jax_lora.compose_lora_params(
        weights_to_flax(trees["base"]), [(to_flax(trees[t]), m) for m, t in pairs],
        jax_lora.LoRASpec(**spec_args))
    want = flatten_dict(want)
    assert got.keys() == trees["base"].keys()
    for k, v in got.items():
        w = np.asarray(want[_fold_path(k.rsplit(".", 1)[0]) + ("kernel",)])
        w = w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(v.numpy(), w, atol=ATOL, err_msg=k)


def test_compose_with_every_multiplier_zero_is_the_base(trees):
    got = lora.compose_lora_params(trees["base"], [(trees["a"], 0.0)],
                                   lora.LoRASpec(**SPEC_ARGS))
    assert got is trees["base"]


def test_jax_saved_file_reads_in_the_port(trees, tmp_path):
    f = tmp_path / "jax.safetensors"
    jax_lora.save_lora_weights(f, to_flax(trees["a"]), jax_lora.LoRASpec(**SPEC_ARGS))
    got = lora.load_lora_weights(f, trees["ref"])
    assert got.keys() == trees["ref"].keys()
    for k, v in got.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, trees["a"][k], rtol=0, atol=0)


def test_port_saved_file_reads_in_jax(trees, tmp_path):
    f = tmp_path / "port.safetensors"
    lora.save_lora_weights(f, trees["a"], lora.LoRASpec(**SPEC_ARGS))
    got = jax_lora.load_lora_weights(f, to_flax(trees["ref"]))
    assert_trees_equal(trees["a"], got, atol=0)
    # and the port reads its own file back
    back = lora.load_lora_weights(f, trees["ref"])
    for k, v in back.items():
        torch.testing.assert_close(v, trees["a"][k], rtol=0, atol=0)


def test_file_alpha_two_under_spec_alpha_one(trees, tmp_path):
    """A file trained at alpha 2 loaded for a spec at alpha 1: lora_up x 2 in
    both packages; without a spec (or at alpha 2) the file's values."""
    f = tmp_path / "alpha2.safetensors"
    lora.save_lora_weights(f, trees["a"], lora.LoRASpec(rank=4, alpha=2.0, network_type="c3lier"))
    got = lora.load_lora_weights(f, trees["ref"], lora.LoRASpec(**SPEC_ARGS))
    want = jax_lora.load_lora_weights(f, to_flax(trees["ref"]), jax_lora.LoRASpec(**SPEC_ARGS))
    assert_trees_equal(got, want, atol=0)
    for k, v in got.items():
        factor = 2.0 if k.endswith(".lora_up") else 1.0
        torch.testing.assert_close(v, trees["a"][k] * factor, rtol=0, atol=0)
    for spec in (None, lora.LoRASpec(rank=4, alpha=2.0, network_type="c3lier")):
        plain = lora.load_lora_weights(f, trees["ref"], spec)
        for k, v in plain.items():
            torch.testing.assert_close(v, trees["a"][k], rtol=0, atol=0)


def test_unmatched_layer_raises(trees, tmp_path):
    f = tmp_path / "extra.safetensors"
    state = lora.export_lora_state(trees["a"], lora.LoRASpec(**SPEC_ARGS))
    state["lora_unet_mid_block_nonexistent.lora_down.weight"] = torch.zeros(4, 8)
    lora.write_safetensors(f, state)
    with pytest.raises(KeyError, match="does not match any model layer"):
        lora.load_lora_weights(f, trees["ref"])
    with pytest.raises(KeyError, match="does not match any model layer"):
        jax_lora.load_lora_weights(f, to_flax(trees["ref"]))
