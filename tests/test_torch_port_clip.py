"""The port's CLIP text encoder against the JAX package's, with shared
weights: tiny towers with quick_gelu and gelu, with and without
text_projection; last hidden state, pooled output and every hidden state.
The port's state_dict is HF-keyed; the JAX tree comes from it through the
JAX package's own `torch_clip_to_flax`, so the names are checked too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.models import clip as jax_clip
from leco_tpu.models.convert import torch_clip_to_flax
from leco_tpu_torch.models import clip
from leco_tpu_torch.testing import random_clip_state

ATOL = 1e-5  # fp32, the two sides differ by summation order only


def _config(act, layers, projection_dim=None):
    return clip.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                               num_hidden_layers=layers, num_attention_heads=4,
                               hidden_act=act, projection_dim=projection_dim,
                               eos_token_id=999)


@pytest.mark.parametrize("act,layers,proj", [("quick_gelu", 2, None), ("gelu", 3, None),
                                             ("gelu", 2, 16)])
def test_outputs_match_jax(act, layers, proj):
    cfg = _config(act, layers, proj)
    state = random_clip_state(cfg, seed=layers, dtype=torch.float32)
    rng = np.random.default_rng(0)
    state = {k: v + 0.02 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in state.items()}  # biases and LN shifts off zero
    model = clip.CLIPTextModel(cfg)
    model.load_state_dict(state, strict=True)

    ids = rng.integers(0, 999, (3, 77)).astype(np.int32)
    ids[0, 5], ids[1, 76], ids[2, 3], ids[2, 9] = 999, 999, 999, 999  # EOS: first one pools
    with torch.no_grad():
        last, pooled, hidden = model(torch.from_numpy(ids).long())
    jax_model = jax_clip.CLIPTextModel(config=jax_clip.CLIPTextConfig(**dataclasses.asdict(cfg)))
    params = torch_clip_to_flax({k: v.numpy() for k, v in state.items()}, layers)
    want_last, want_pooled, want_hidden = jax_model.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(ids))
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL)
    assert len(hidden) == len(want_hidden) == layers + 1
    for got, want in zip(hidden, want_hidden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sd_configs_match_jax():
    assert dataclasses.asdict(clip.sd1_text_config()) == dataclasses.asdict(jax_clip.sd1_text_config())
    for n in (23, 22):
        assert dataclasses.asdict(clip.sd2_text_config(n)) == dataclasses.asdict(
            jax_clip.sd2_text_config(n))


def test_bf16_keeps_fp32_layer_norms():
    cfg = _config("gelu", 2)
    model = clip.CLIPTextModel(cfg)
    model.load_state_dict(random_clip_state(cfg, dtype=torch.float32))
    ids = torch.randint(0, 999, (1, 77))
    with torch.no_grad():
        ref = model(ids)[0]
        got = model.to(torch.bfloat16)(ids)[0]
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() < 0.1  # bf16 compute, fp32 statistics
