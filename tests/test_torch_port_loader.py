"""The port's `load_models` against the JAX package's, on tiny checkpoints
written by `leco_tpu_torch.testing`: a diffusers directory and an SD2-style
single file (the loaders' SD2.1 UNet and text configs swapped for tiny ones
on both sides, the widths cut, the structure kept: linear projections,
upcast, a 24-layer OpenCLIP tower of which 23 load). The JAX LoRA leaves are
carried across through `flax_unet_to_torch`, so one UNet forward and one
text encoding compare like with like. Then the loader's checks and the file
formats it reads."""

import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu import lora as jax_lora
from leco_tpu.models import clip as jax_clip
from leco_tpu.models import convert as jax_convert
from leco_tpu.models import loader as jax_loader
from leco_tpu.models import unet as jax_unet
from leco_tpu_torch import testing
from leco_tpu_torch.lora import LoRASpec, lora_parameters, read_safetensors, write_safetensors
from leco_tpu_torch.models import loader
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.convert import flax_unet_to_torch
from leco_tpu_torch.models.unet import UNetConfig, tiny_unet_config

UNET_ATOL = 2e-4  # the repo's fp32 full-UNet bound (test_torch_unet_fullgraph.py)
TEXT_ATOL = 1e-5
TINY_21 = dataclasses.replace(tiny_unet_config(32), attention_head_dim=(2, 4), layers_per_block=2,
                              use_linear_projection=True, upcast_attention=True)


def tiny_text(layers: int = 2) -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
                          num_attention_heads=2, hidden_act="gelu")


def _jax_twin(cfg, cls):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def diffusers_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("diffusers")
    return testing.write_diffusers_checkpoint(root, tiny_unet_config(32), tiny_text(2), seed=3)


@pytest.fixture(scope="module")
def single_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("single") / "tiny-v2.safetensors"
    return testing.write_single_file_checkpoint(path, TINY_21, tiny_text(24), seed=5,
                                                dtype=torch.float32)


@pytest.fixture
def tiny_sd2(monkeypatch):
    """Both loaders' SD2.1 configs -> the tiny ones (the JAX loader also
    splits in_proj at 32 rows, as it would at 1024)."""
    monkeypatch.setattr(loader, "sd21_config", lambda: TINY_21)
    monkeypatch.setattr(loader, "sd2_text_config", tiny_text)
    monkeypatch.setattr(jax_unet, "sd21_config", lambda: _jax_twin(TINY_21, jax_unet.UNetConfig))
    monkeypatch.setattr(jax_loader, "sd2_text_config",
                        lambda n: _jax_twin(tiny_text(n), jax_clip.CLIPTextConfig))
    monkeypatch.setattr(jax_convert, "ldm_openclip_to_hf",
                        functools.partial(jax_convert.ldm_openclip_to_hf, hidden_size=32))


def _compare(path: str, **kw):
    """Load with both packages; carry the JAX LoRA leaves (perturbed off
    zero) to the port; -> (port outputs, JAX outputs)."""
    jm = jax_loader.load_models(path, "ddim", lora_spec=jax_lora.LoRASpec(4, 1.0), remat=False,
                                **kw)
    pm = loader.load_models(path, "ddim", lora_spec=LoRASpec(4, 1.0), **kw)
    rng = np.random.default_rng(0)
    lora_tree = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        jm.unet_lora_params)
    carried = flax_unet_to_torch(lora_tree)
    assert set(carried) == set(lora_parameters(pm.unet))
    pm.unet.load_state_dict(carried, strict=False)

    # the base weights are the checkpoint's on both sides
    base = flax_unet_to_torch(jax.tree.map(np.asarray, jm.unet_base_params))
    state = pm.unet.state_dict()
    for k, v in base.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)

    cfg = pm.unet_config
    sample = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([501.0, 33.0], np.float32)
    want_unet = jm.unet.apply({"params": jax_lora.merge_params(jm.unet_base_params, lora_tree)},
                              jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got_unet = pm.unet(torch.from_numpy(sample.transpose(0, 3, 1, 2)), torch.from_numpy(t),
                           torch.from_numpy(ctx)).numpy().transpose(0, 2, 3, 1)

    prompts = ["van gogh", "", "a cat with ears, realistic"]
    ids = pm.tokenizer(prompts)
    np.testing.assert_array_equal(ids, jm.tokenizer(prompts))
    te = jm.text_encoder
    want_text = te.model.apply({"params": te.params}, jnp.asarray(ids))
    with torch.no_grad():
        got_text = pm.text_encoder(torch.from_numpy(ids).long())
    assert pm.text_encoder.config.num_hidden_layers == te.config.num_hidden_layers
    assert pm.scheduler.prediction_type == jm.scheduler.prediction_type
    return pm, (got_unet, got_text), (np.asarray(want_unet), want_text)


def _check_outputs(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=UNET_ATOL)
    for g, w in zip(got[1][:2], want[1][:2]):  # last, pooled
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TEXT_ATOL)


def test_diffusers_directory_matches_jax(diffusers_dir):
    pm, got, want = _compare(str(diffusers_dir))
    _check_outputs(got, want)
    assert pm.text_encoder.config.num_hidden_layers == 2


@pytest.mark.parametrize("clip_skip,layers", [(None, 23), (2, 23), (3, 22)])
def test_v2_single_file_matches_jax(single_file, tiny_sd2, clip_skip, layers):
    pm, got, want = _compare(str(single_file), v2=True, v_pred=True, clip_skip=clip_skip)
    _check_outputs(got, want)
    assert pm.text_encoder.config.num_hidden_layers == layers
    assert pm.scheduler.prediction_type == "v_prediction"
    assert pm.unet_config == TINY_21


def test_dtypes_and_devices(single_file, tiny_sd2):
    """Conv and linear weights take the weight dtype; norms are rounded to it
    and kept fp32; LoRA masters are fp32; nothing is left on meta."""
    pm = loader.load_models(str(single_file), v2=True, weight_dtype=torch.bfloat16,
                            lora_spec=LoRASpec(4, 1.0))
    unet = pm.unet
    assert unet.conv_in.weight.dtype == torch.bfloat16
    norm = unet.down_blocks[0].resnets[0].norm1.weight
    assert norm.dtype == torch.float32
    src = read_safetensors(single_file)[0]["model.diffusion_model.input_blocks.1.0.in_layers.0.weight"]
    assert torch.equal(norm, src.to(torch.bfloat16).float())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in lora_parameters(unet).values())
    assert not any(p.requires_grad for n, p in unet.named_parameters() if ".lora_" not in n)
    assert all(p.device.type == "cpu" for p in [*unet.parameters(), *pm.text_encoder.parameters()])
    assert pm.text_encoder.text_model.embeddings.token_embedding.weight.dtype == torch.bfloat16


def test_v2_flag_checks(single_file, tiny_sd2, monkeypatch):
    with pytest.raises(ValueError, match="cross-attention dim is 32 but v2=False"):
        loader.load_models(str(single_file), v2=False)
    monkeypatch.setattr(loader, "sd21_config",
                        lambda: dataclasses.replace(TINY_21, use_linear_projection=False))
    with pytest.raises(ValueError, match="proj_in is linear but the v2=True config expects conv"):
        loader.load_models(str(single_file), v2=True)


def test_single_file_refusals(single_file, tmp_path, tiny_sd2):
    sdxl = tmp_path / "xl.safetensors"
    write_safetensors(sdxl, {"conditioner.embedders.1.model.ln_final.weight": torch.ones(2),
                             "model.diffusion_model.out.2.bias": torch.zeros(4)})
    with pytest.raises(ValueError, match="SDXL"):
        loader.load_models(str(sdxl))
    lone = tmp_path / "lone" / single_file.name
    lone.parent.mkdir()
    shutil.copy(single_file, lone)  # no tokenizer/ beside it
    with pytest.raises(FileNotFoundError, match="tokenizer/ directory"):
        loader.load_models(str(lone), v2=True)
    with pytest.raises(FileNotFoundError, match="offline-only"):
        loader.load_models(str(tmp_path / "missing"))


def test_ckpt_and_sharded_files_load_the_same(diffusers_dir, single_file, tmp_path, tiny_sd2):
    """`.ckpt` (torch.load, weights_only, "state_dict" unwrapped) and a
    sharded `*.index.json` component give the tensors of the originals."""
    sd = read_safetensors(single_file)[0]
    ckpt = tmp_path / "tiny-v2.ckpt"
    torch.save({"state_dict": sd, "global_step": 7}, ckpt)
    shutil.copytree(single_file.parent / "tokenizer", tmp_path / "tokenizer")
    a = loader.load_models(str(single_file), v2=True)
    b = loader.load_models(str(ckpt), v2=True)
    for (k, v), w in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(v, w), k

    unet_sd = read_safetensors(diffusers_dir / "unet" / "diffusion_pytorch_model.safetensors")[0]
    shard_dir = tmp_path / "sharded"
    shutil.copytree(diffusers_dir, shard_dir)
    (shard_dir / "unet" / "diffusion_pytorch_model.safetensors").unlink()
    keys = sorted(unet_sd)
    weight_map = {}
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        name = f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"
        write_safetensors(shard_dir / "unet" / name, {k: unet_sd[k] for k in part})
        weight_map.update({k: name for k in part})
    (shard_dir / "unet" / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    assert loader.load_component_tensors(str(shard_dir / "unet")).keys() == unet_sd.keys()
    c = loader.load_models(str(shard_dir))
    d = loader.load_models(str(diffusers_dir))
    for (k, v), w in zip(c.unet.state_dict().items(), d.unet.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("cfg", [
    {"down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
     "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "block_out_channels": [8, 16],
     "attention_head_dim": [2, 4], "use_linear_projection": True, "upcast_attention": None,
     "cross_attention_dim": 1024, "layers_per_block": 1, "norm_num_groups": 4},
    {"down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
     "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
     "block_out_channels": [320, 640, 1280, 1280], "attention_head_dim": 8,
     "num_attention_heads": [5, 10, 20, 20], "transformer_layers_per_block": [1, 1, 1, 1]},
])
def test_unet_config_from_json_matches_jax(cfg):
    got = dataclasses.asdict(loader.unet_config_from_json(cfg))
    want = dataclasses.asdict(jax_loader.unet_config_from_json(cfg))
    assert got == {k: want[k] for k in got}
    assert got.keys() == {f.name for f in dataclasses.fields(UNetConfig)}


@pytest.mark.parametrize("clip_skip", [None, 1, 2, 5])
@pytest.mark.parametrize("cfg", [
    {"num_hidden_layers": 23, "hidden_size": 1024, "hidden_act": "gelu",
     "num_attention_heads": 16, "intermediate_size": 4096},
    {"architectures": ["CLIPTextModelWithProjection"], "projection_dim": 1280,
     "num_hidden_layers": 6},
])
def test_clip_config_from_json_matches_jax(cfg, clip_skip):
    got = dataclasses.asdict(loader.clip_config_from_json(cfg, clip_skip))
    assert got == dataclasses.asdict(jax_loader.clip_config_from_json(cfg, clip_skip))


def test_clip_skip_past_the_config_raises():
    with pytest.raises(ValueError, match="already be truncated"):
        loader.clip_config_from_json({"num_hidden_layers": 2}, clip_skip=3)
