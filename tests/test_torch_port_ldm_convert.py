"""The port's LDM single-file remaps against the JAX package's, on
miniature checkpoints from `scripts/gen_ldm_inventory.ldm_unet_inventory`
(SD1.5- and SD2.1-shaped, random values from a numpy seed), and their
inverses, which `leco_tpu_torch.testing` uses to write single files: the
round trips are exact, and the port's full-width SD1.5 / SD2.1 UNets map
onto the key and shape inventories of tests/fixtures/."""

from pathlib import Path

import numpy as np
import pytest
import torch

from leco_tpu.models import convert as jax_convert
from leco_tpu_torch.models import convert
from leco_tpu_torch.models.unet import UNet2DConditionModel, sd15_config, sd21_config
from scripts.gen_ldm_inventory import ldm_unet_inventory

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MINIATURES = {
    "sd15": dict(model_channels=8, context_dim=32),
    "sd21": dict(model_channels=8, context_dim=32, linear_proj=True),
}


def _random(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def _with_extras(sd: dict) -> dict:
    """A single file holds more than the UNet: the VAE and text encoder."""
    return {**sd, "first_stage_model.decoder.conv_in.weight": np.zeros((4, 4), np.float32),
            "cond_stage_model.transformer.text_model.final_layer_norm.weight": np.ones(3, np.float32)}


@pytest.mark.parametrize("name", list(MINIATURES))
def test_unet_remap_matches_jax(name):
    ldm = _with_extras(_random(ldm_unet_inventory(**MINIATURES[name]), 0))
    want = jax_convert.ldm_unet_to_diffusers(ldm)
    got = convert.ldm_unet_to_diffusers({k: torch.from_numpy(v) for k, v in ldm.items()})
    _assert_same(got, want)


@pytest.mark.parametrize("name", list(MINIATURES))
def test_unet_remap_inverse_round_trips(name):
    ldm = {k: torch.from_numpy(v) for k, v in _random(ldm_unet_inventory(**MINIATURES[name]), 1).items()}
    back = convert.diffusers_unet_to_ldm(convert.ldm_unet_to_diffusers(ldm))
    _assert_same(back, ldm)


@pytest.mark.parametrize("name,config", [("sd15", sd15_config), ("sd21", sd21_config)])
def test_full_width_unet_maps_onto_the_ldm_inventory(name, config):
    """The port's UNet state_dict, through the inverse remap, is exactly the
    real checkpoint's `model.diffusion_model.*` keys and shapes."""
    with torch.device("meta"):
        state = UNet2DConditionModel(config()).state_dict()
    got = {k: tuple(v.shape) for k, v in convert.diffusers_unet_to_ldm(state).items()}
    want = {}
    for line in (FIXTURES / f"ldm_unet_keys_{name}.txt").read_text().splitlines():
        key, shape = line.split()
        want[key] = tuple(int(x) for x in shape.split(","))
    assert got == want


def test_unet_remap_refuses_leftover_keys():
    ldm = {k: torch.from_numpy(v) for k, v in _random(ldm_unet_inventory(**MINIATURES["sd15"]), 2).items()}
    ldm["model.diffusion_model.input_blocks.1.0.mystery.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not covered"):
        convert.ldm_unet_to_diffusers(ldm)
    with pytest.raises(ValueError, match="no model.diffusion_model"):
        convert.ldm_unet_to_diffusers({"cond_stage_model.x": torch.zeros(1)})


def test_clip_remap_matches_jax():
    sd = _with_extras(_random({
        "cond_stage_model.transformer.text_model.embeddings.token_embedding.weight": (10, 4),
        "cond_stage_model.transformer.text_model.encoder.layers.0.mlp.fc1.weight": (8, 4),
        "model.diffusion_model.out.2.bias": (4,),
    }, 3))
    want = jax_convert.ldm_clip_to_hf(sd)
    _assert_same(convert.ldm_clip_to_hf({k: torch.from_numpy(v) for k, v in sd.items()}), want)


def _openclip_tower(h: int, layers: int, seed: int) -> dict[str, np.ndarray]:
    p = "cond_stage_model.model."
    shapes = {f"{p}token_embedding.weight": (50, h), f"{p}positional_embedding": (77, h),
              f"{p}ln_final.weight": (h,), f"{p}ln_final.bias": (h,),
              f"{p}text_projection": (h, h), f"{p}logit_scale": ()}
    for i in range(layers):
        r = f"{p}transformer.resblocks.{i}."
        shapes.update({
            f"{r}ln_1.weight": (h,), f"{r}ln_1.bias": (h,), f"{r}ln_2.weight": (h,),
            f"{r}ln_2.bias": (h,), f"{r}attn.in_proj_weight": (3 * h, h),
            f"{r}attn.in_proj_bias": (3 * h,), f"{r}attn.out_proj.weight": (h, h),
            f"{r}attn.out_proj.bias": (h,), f"{r}mlp.c_fc.weight": (4 * h, h),
            f"{r}mlp.c_fc.bias": (4 * h,), f"{r}mlp.c_proj.weight": (h, 4 * h),
            f"{r}mlp.c_proj.bias": (h,),
        })
    return _random(shapes, seed)


@pytest.mark.parametrize("h,layers", [(8, 3), (16, 2)])
def test_openclip_remap_matches_jax(h, layers):
    sd = _with_extras(_openclip_tower(h, layers, 4))
    want = jax_convert.ldm_openclip_to_hf(sd, hidden_size=h)
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    # the width is read off in_proj
    _assert_same(convert.ldm_openclip_to_hf(torch_sd), want)
    assert convert.ldm_openclip_to_hf({"first_stage_model.x": torch.zeros(1)}) == {}


def test_openclip_remap_inverse_round_trips():
    sd = _openclip_tower(8, 3, 5)
    del sd["cond_stage_model.model.logit_scale"]  # not a text-encoder tensor
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_same(convert.hf_clip_to_openclip(convert.ldm_openclip_to_hf(torch_sd)), torch_sd)
