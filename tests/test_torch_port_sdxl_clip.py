"""SDXL's text side in the port against the JAX package: the bigG config, a
narrow bigG-shaped tower with its projection (last state, pooled output and
`hidden_states[-2]`, SDXL's sequence embedding), the meaning of index -2 in
both packages, the XL prompt encoder against the one the JAX CLI builds
(train_lora_xl.py:58-69, captured from the JAX CLI itself on a tiny SDXL
directory) and tokenizer_2's padding."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.models import clip as jax_clip
from leco_tpu.models.convert import torch_clip_to_flax
from leco_tpu_torch.models import clip, loader
from leco_tpu_torch.testing import random_clip_state
from leco_tpu_torch.prompts import make_encode_fn_xl
from tests.test_torch_port_sdxl_loader import write_tiny_xl_dir

ATOL = 1e-5  # fp32, the two sides differ by summation order only


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bigg(width: int, heads: int, layers: int, projection: int) -> clip.CLIPTextConfig:
    """bigG's shape, cut: gelu, 4x MLP, a projection, CLIP's vocabulary."""
    return dataclasses.replace(clip.sdxl_text2_config(), hidden_size=width,
                               intermediate_size=4 * width, num_attention_heads=heads,
                               num_hidden_layers=layers, projection_dim=projection)


def _perturbed_model(cfg, seed):
    state = random_clip_state(cfg, seed=seed, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    state = {k: v + 0.02 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in state.items()}
    model = clip.CLIPTextModel(cfg)
    model.load_state_dict(state, strict=True)
    return model, state


def test_sdxl_text2_config_matches_jax():
    assert dataclasses.asdict(clip.sdxl_text2_config()) == dataclasses.asdict(
        jax_clip.sdxl_text2_config())
    cfg = clip.sdxl_text2_config()
    with torch.device("meta"):
        model = clip.CLIPTextModel(cfg)
    # bigG's text tower with its projection: 694.7M parameters
    assert sum(p.numel() for p in model.parameters()) == 694_659_840
    assert cfg.hidden_size // cfg.num_attention_heads == 64


@pytest.mark.parametrize("width,heads,layers,projection", [(40, 5, 4, 16), (64, 4, 3, 64)])
def test_bigg_shaped_tower_matches_jax(width, heads, layers, projection):
    cfg = _bigg(width, heads, layers, projection)
    model, state = _perturbed_model(cfg, layers)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 49406, (3, 77)).astype(np.int32)
    ids[0, 5], ids[1, 76], ids[2, 3] = 49407, 49407, 49407  # EOS: the first one pools
    with torch.no_grad():
        last, pooled, hidden = model(torch.from_numpy(ids).long())
    jax_model = jax_clip.CLIPTextModel(config=jax_clip.CLIPTextConfig(**dataclasses.asdict(cfg)))
    params = torch_clip_to_flax({k: v.numpy() for k, v in state.items()}, layers)
    want_last, want_pooled, want_hidden = jax_model.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(ids))
    assert pooled.shape == (3, projection)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL)
    np.testing.assert_allclose(hidden[-2].numpy(), np.asarray(want_hidden[-2]), atol=ATOL)
    assert len(hidden) == len(want_hidden) == layers + 1


def test_hidden_minus_two_is_the_penultimate_layer_in_both_packages():
    """[0] is the embeddings in both orders, so [-2] is the output of the
    next-to-last layer before the final LayerNorm: the last state of the
    same tower one layer shorter, without its final LayerNorm."""
    cfg = _bigg(32, 4, 3, 16)
    model, state = _perturbed_model(cfg, 3)
    short_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    short = clip.CLIPTextModel(short_cfg)
    short.load_state_dict({k: v for k, v in state.items() if ".layers.2." not in k})
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 49406, (2, 77)))
    with torch.no_grad():
        hidden = model(ids)[2]
        short_hidden = short(ids)[2]
    assert len(hidden) == 4
    torch.testing.assert_close(hidden[-2], short_hidden[-1], rtol=0, atol=0)
    jax_model = jax_clip.CLIPTextModel(config=jax_clip.CLIPTextConfig(**dataclasses.asdict(cfg)))
    params = torch_clip_to_flax({k: v.numpy() for k, v in state.items()}, 3)
    _, _, want_hidden = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)},
                                        jnp.asarray(ids.numpy().astype(np.int32)))
    np.testing.assert_allclose(np.asarray(want_hidden[-2]), short_hidden[-1].numpy(), atol=ATOL)


@pytest.fixture(scope="module")
def xl_dir(tmp_path_factory):
    return write_tiny_xl_dir(tmp_path_factory.mktemp("xl_clip"), seed=11)


def test_xl_encode_fn_matches_the_jax_cli(xl_dir, tmp_path, monkeypatch):
    """The JAX CLI's encode_fn, taken from the bundle its `main` hands to
    train(), against `make_encode_fn_xl` over the port's load of the same
    directory: the (1, 77, 768 + 1280)-shaped concatenation of each tower's
    penultimate state and bigG's pooled projection."""
    import leco_tpu.train.trainer as jax_trainer
    import train_lora_xl as jax_cli

    (tmp_path / "prompts.yaml").write_text("- target: 'van gogh'\n  resolution: 64\n")
    config = tmp_path / "config.yaml"
    config.write_text(f"prompts_file: '{tmp_path / 'prompts.yaml'}'\n"
                      f"pretrained_model:\n  name_or_path: '{xl_dir}'\n"
                      "train:\n  precision: float32\n"
                      f"save:\n  path: '{tmp_path / 'out'}'\n"
                      "other:\n  use_flash_attention: false\n")
    captured = {}
    monkeypatch.setenv("LECO_TPU_CACHE", "0")  # no compilation cache under HOME
    monkeypatch.setattr(jax_trainer, "train",
                        lambda config, prompts, bundle, mesh=None: captured.update(bundle=bundle))
    jax_cli.main(argparse.Namespace(config_file=str(config)))
    jax_encode = captured["bundle"].encode_fn

    pm = loader.load_models_xl(str(xl_dir), checkpoint_unet=False)
    encode = make_encode_fn_xl([pm.tokenizer, pm.tokenizer_2],
                               [pm.text_encoder, pm.text_encoder_2], "cpu")
    for prompt in ("van gogh", "", "a cat with ears, realistic"):
        got, want = encode(prompt), jax_encode(prompt)
        assert got.text_embeds.shape == (1, 77, 32) and got.pooled_embeds.shape == (1, 8)
        np.testing.assert_allclose(got.text_embeds.numpy(), np.asarray(want.text_embeds),
                                   atol=ATOL)
        np.testing.assert_allclose(got.pooled_embeds.numpy(), np.asarray(want.pooled_embeds),
                                   atol=ATOL)


def test_tokenizer_2_pads_with_zero(xl_dir):
    """tokenizer_2 pads with id 0 (model_util.py:150); tokenizer with EOS."""
    pm = loader.load_models_xl(str(xl_dir), checkpoint_unet=False)
    ids1, ids2 = pm.tokenizer(["van gogh"])[0], pm.tokenizer_2(["van gogh"])[0]
    np.testing.assert_array_equal(ids1[:4], ids2[:4])  # BOS, van, gogh, EOS
    assert ids1[3] == ids2[3] == 49407
    assert (ids2[4:] == 0).all() and (ids1[4:] == 49407).all()
