"""The port's CLIP vision tower, image preprocessing, CLIP score and scorer
against the JAX package's.

The tower: the JAX package's tiny config and init, every leaf perturbed
from a numpy seed, carried by `flax_clip_vision_to_torch`; fp32 within
1e-5 x max|out|. `preprocess_images` (uint8 and [0, 1] floats, shrinking at
SD's 512 -> 224 ratio and growing) within 1e-5 (the same triangle filter,
summed in another order). The scorer: one tiny CLIP directory written by
`leco_tpu_torch.testing.write_clip_dir`, loaded by both packages'
`CLIPScorer.from_pretrained`, text and image embeddings within 1e-5 x
max|ref|, scores within 1e-3 (a score is 100 x a cosine)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from leco_tpu import eval as jax_eval
from leco_tpu.models import clip_vision as jcv
from leco_tpu_torch import eval as port_eval
from leco_tpu_torch import testing
from leco_tpu_torch.models import clip_vision as cv
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.convert import flax_clip_vision_to_torch

RTOL = 1e-5


@pytest.fixture(scope="module")
def tower():
    rng = np.random.default_rng(0)
    cfg = jcv.tiny_vision_config()
    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    model = jcv.CLIPVisionModel(config=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = unflatten_dict({k: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
                             for k, v in flatten_dict(params).items()})
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    return dict(params=params, x=x, want=want)


def test_vision_tower_matches_jax(tower):
    port = cv.CLIPVisionModel(cv.tiny_vision_config())
    sd = flax_clip_vision_to_torch(tower["params"])
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(tower["x"].transpose(0, 3, 1, 2))).numpy()
    want = tower["want"]
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max())


def test_vit_l_parameter_count():
    """openai/clip-vit-large-patch14's vision tower with its projection: 304M
    (the JAX package's count, tests/test_eval_clip.py)."""
    with torch.device("meta"):
        model = cv.CLIPVisionModel(cv.CLIPVisionConfig())
    assert sum(p.numel() for p in model.parameters()) == 303_966_208


@pytest.mark.parametrize("shape,size", [((2, 512, 512, 3), 224), ((1, 128, 96, 3), 56),
                                        ((2, 20, 30, 3), 32), ((1, 64, 48, 3), 224)])
@pytest.mark.parametrize("kind", ["uint8", "unit_float"])
def test_preprocess_images_matches_jax(shape, size, kind):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "unit_float":  # max <= 1.5: not divided by 255
        images = images.astype(np.float32) / 255.0
    got = cv.preprocess_images(images, size).numpy()
    want = np.asarray(jcv.preprocess_images(images, size))
    assert got.shape == (shape[0], 3, size, size)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=RTOL)


def test_clip_score_matches_jax():
    rng = np.random.default_rng(2)
    ie = rng.standard_normal((5, 8)).astype(np.float32)
    te = rng.standard_normal((5, 8)).astype(np.float32)
    te[0] = -ie[0]  # a negative cosine, clipped at 0
    got = cv.clip_score(torch.from_numpy(ie), torch.from_numpy(te)).numpy()
    want = np.asarray(jcv.clip_score(jnp.asarray(ie), jnp.asarray(te)))
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, atol=1e-4)
    e = torch.eye(2)
    np.testing.assert_allclose(cv.clip_score(e, e).numpy(), [100.0, 100.0], atol=1e-4)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    return testing.write_clip_dir(
        root, CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=2),
        cv.tiny_vision_config(), projection_dim=16, seed=3)


def test_scorer_matches_jax_on_one_dir(clip_dir):
    port = port_eval.CLIPScorer.from_pretrained(str(clip_dir), device="cpu")
    jax_scorer = jax_eval.CLIPScorer.from_pretrained(str(clip_dir))
    assert port.image_size == jax_scorer.image_size == 32
    texts = ["van gogh", "a cat with cat ears"]
    te, jte = port.text_embeds(texts).numpy(), np.asarray(jax_scorer.text_embeds(texts))
    assert te.shape == (2, 16)
    np.testing.assert_allclose(te, jte, atol=RTOL * np.abs(jte).max())
    images = np.random.default_rng(4).integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    ie, jie = port.image_embeds(images).numpy(), np.asarray(jax_scorer.image_embeds(images))
    np.testing.assert_allclose(ie, jie, atol=RTOL * np.abs(jie).max())
    got, want = port.score(images, ["van gogh"]), jax_scorer.score(images, ["van gogh"])
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3)
