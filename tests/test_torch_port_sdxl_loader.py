"""The port's `load_models_xl` against the JAX package's, on tiny SDXL
checkpoints written by `leco_tpu_torch.testing`: a diffusers directory
(`unet/` with text_time, `text_encoder/`, `text_encoder_2/` with its
projection, `tokenizer/`, `tokenizer_2/`) and an SDXL LDM single file (the
loaders' SDXL UNet and text configs swapped for the tiny ones on both sides:
the structure kept, the widths cut). The JAX LoRA leaves are carried across
through `flax_unet_to_torch`, so one UNet forward (with the added
conditioning) and both text encodings compare like with like. Then the
written LDM keys against the SGM inventory (`scripts/gen_ldm_inventory.py`,
INVENTORIES["sdxl"]) and the SD loader's refusal of an SDXL file."""

import dataclasses
from pathlib import Path

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
from leco_tpu_torch.lora import LoRASpec, lora_parameters
from leco_tpu_torch.models import convert, loader
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.unet import UNet2DConditionModel, sdxl_config
from leco_tpu_torch.models.convert import flax_unet_to_torch
from scripts.gen_ldm_inventory import INVENTORIES, ldm_unet_inventory
from tests.test_torch_port_sdxl_unet import xl_inputs

FIXTURES = Path(__file__).resolve().parent / "fixtures"
UNET_ATOL = 2e-4  # the repo's fp32 full-UNet bound (test_torch_unet_fullgraph.py)
TEXT_ATOL = 1e-5
# SDXL's two towers, cut: CLIP-L (quick_gelu, no projection) and bigG (gelu,
# the pooled projection); 16 + 16 = the tiny UNet's 32-wide context, and
# bigG's 8-wide projection its pooled width
TE1 = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                     num_attention_heads=2)
TE2 = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=3,
                     num_attention_heads=2, hidden_act="gelu", projection_dim=8)
TINY_XL = testing.tiny_xl_unet_config()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_tiny_xl_dir(root: Path, seed: int = 3) -> Path:
    return testing.write_sdxl_diffusers_checkpoint(root, TINY_XL, TE1, TE2, seed=seed)


def _jax_twin(cfg, cls):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def diffusers_dir(tmp_path_factory):
    return write_tiny_xl_dir(tmp_path_factory.mktemp("xl"))


@pytest.fixture(scope="module")
def single_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("xl_single") / "tiny-xl.safetensors"
    return testing.write_sdxl_single_file(path, TINY_XL, TE1, TE2, seed=5, dtype=torch.float32)


@pytest.fixture
def tiny_xl(monkeypatch):
    """Both loaders' SDXL configs -> the tiny ones (the JAX loader splits
    bigG's in_proj at 16 rows, as it would at 1280)."""
    monkeypatch.setattr(loader, "sdxl_config", lambda: TINY_XL)
    monkeypatch.setattr(loader, "sd1_text_config", lambda: TE1)
    monkeypatch.setattr(loader, "sdxl_text2_config", lambda: TE2)
    monkeypatch.setattr(jax_unet, "sdxl_config", lambda: _jax_twin(TINY_XL, jax_unet.UNetConfig))
    monkeypatch.setattr(jax_clip, "sd1_text_config",
                        lambda: _jax_twin(TE1, jax_clip.CLIPTextConfig))
    monkeypatch.setattr(jax_clip, "sdxl_text2_config",
                        lambda: _jax_twin(TE2, jax_clip.CLIPTextConfig))
    real = jax_convert.ldm_openclip_to_hf
    monkeypatch.setattr(jax_convert, "ldm_openclip_to_hf",
                        lambda sd, hidden_size=None, prefix=None: real(
                            sd, hidden_size=TE2.hidden_size, prefix=prefix))


def load_both(path: str):
    jm = jax_loader.load_models_xl(path, "ddim", lora_spec=jax_lora.LoRASpec(4, 1.0),
                                   remat=False)
    pm = loader.load_models_xl(path, "ddim", lora_spec=LoRASpec(4, 1.0), checkpoint_unet=False)
    return pm, jm


def _compare(path: str):
    """Load with both packages; carry the JAX LoRA leaves (perturbed off
    zero) to the port; -> (port models, port outputs, JAX outputs)."""
    pm, jm = load_both(path)
    rng = np.random.default_rng(0)
    lora_tree = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        jm.unet_lora_params)
    carried = flax_unet_to_torch(lora_tree)
    assert set(carried) == set(lora_parameters(pm.unet))
    pm.unet.load_state_dict(carried, strict=False)
    base = flax_unet_to_torch(jax.tree.map(np.asarray, jm.unet_base_params))
    state = pm.unet.state_dict()
    assert set(base) | set(carried) == set(state)
    for k, v in base.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)

    sample, t, ctx, added = xl_inputs(rng, pm.unet_config, latent=16)
    want_unet = jm.unet.apply({"params": jax_lora.merge_params(jm.unet_base_params, lora_tree)},
                              jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                              {k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got_unet = pm.unet(torch.from_numpy(sample.transpose(0, 3, 1, 2)), torch.from_numpy(t),
                           torch.from_numpy(ctx), {k: torch.from_numpy(v) for k, v in
                                                   added.items()}).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got_unet, np.asarray(want_unet), atol=UNET_ATOL)

    prompts = ["van gogh", "", "a cat with ears, realistic"]
    for tok, te, jtok, jte in ((pm.tokenizer, pm.text_encoder, jm.tokenizer, jm.text_encoder),
                               (pm.tokenizer_2, pm.text_encoder_2, jm.tokenizer_2,
                                jm.text_encoder_2)):
        ids = tok(prompts)
        np.testing.assert_array_equal(ids, jtok(prompts))
        want = jte.model.apply({"params": jte.params}, jnp.asarray(ids))
        with torch.no_grad():
            got = te(torch.from_numpy(ids).long())
        assert te.config == _port_twin(jte.config)
        for g, w in zip(got[:2], want[:2]):  # last, pooled
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TEXT_ATOL)
        np.testing.assert_allclose(got[2][-2].numpy(), np.asarray(want[2][-2]), atol=TEXT_ATOL)
    assert pm.scheduler.prediction_type == jm.scheduler.prediction_type == "epsilon"
    assert dataclasses.asdict(pm.unet_config) == dataclasses.asdict(jm.unet_config)
    return pm


def _port_twin(jax_cfg) -> CLIPTextConfig:
    return CLIPTextConfig(**dataclasses.asdict(jax_cfg))


def test_diffusers_directory_matches_jax(diffusers_dir):
    pm = _compare(str(diffusers_dir))
    assert pm.is_xl and pm.unet.is_xl
    assert pm.text_encoder_2.config.projection_dim == 8
    assert pm.tokenizer_2.pad_token_id == 0 and pm.tokenizer.pad_token_id == 49407


def test_single_file_matches_jax(single_file, tiny_xl):
    pm = _compare(str(single_file))
    assert pm.unet_config == TINY_XL and pm.text_encoder_2.config == TE2


def test_single_file_weights_are_the_diffusers_weights(single_file, tiny_xl):
    """The single file's three parts reach the same modules a diffusers
    dir of them would fill: every tensor of the file has a home."""
    pm = loader.load_models_xl(str(single_file), checkpoint_unet=False)
    tensors, _ = loader.read_safetensors(str(single_file))
    unet = convert.ldm_unet_to_diffusers(tensors)
    for k, v in pm.unet.state_dict().items():
        torch.testing.assert_close(v, unet[k], rtol=0, atol=0, msg=k)
    te1 = convert.ldm_clip_to_hf(tensors, prefix=convert.XL_CLIP_PREFIX)
    te2 = convert.ldm_openclip_to_hf(tensors, prefix=convert.XL_OPENCLIP_PREFIX)
    for model, sd in ((pm.text_encoder, te1), (pm.text_encoder_2, te2)):
        assert set(model.state_dict()) == set(sd)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    assert sum(t.numel() for t in tensors.values()) == sum(
        p.numel() for m in (pm.unet, pm.text_encoder, pm.text_encoder_2)
        for n, p in m.state_dict().items() if ".lora_" not in n)


def test_written_ldm_keys_are_the_sgm_inventory():
    """The tiny XL UNet (channels 8/16/32, depths 0/2/10, context 32, added
    input 32) through the inverse remap is exactly the SGM UNetModel's key
    and shape inventory at those widths; the full-width one, the fixture."""
    cfg = testing.tiny_xl_unet_config(depth=10)
    with torch.device("meta"):
        state = UNet2DConditionModel(cfg).state_dict()
    got = {k: tuple(v.shape) for k, v in convert.diffusers_unet_to_ldm(state).items()}
    want = ldm_unet_inventory(**{**INVENTORIES["sdxl"], "model_channels": 8,
                                 "context_dim": cfg.cross_attention_dim,
                                 "adm_in_channels": cfg.projection_class_embeddings_input_dim})
    assert got == {f"model.diffusion_model.{k}" if not k.startswith("model.") else k: tuple(v)
                   for k, v in want.items()}
    with torch.device("meta"):
        state = UNet2DConditionModel(sdxl_config()).state_dict()
    got = {k: tuple(v.shape) for k, v in convert.diffusers_unet_to_ldm(state).items()}
    fixture = {}
    for line in (FIXTURES / "ldm_unet_keys_sdxl.txt").read_text().splitlines():
        key, shape = line.split()
        fixture[key] = tuple(int(x) for x in shape.split(","))
    assert got == fixture


def test_unet_remap_of_the_sgm_inventory_matches_jax():
    ldm = {k: np.random.default_rng(1).standard_normal(s).astype(np.float32)
           for k, s in ldm_unet_inventory(**{**INVENTORIES["sdxl"], "model_channels": 8,
                                             "context_dim": 32, "adm_in_channels": 32}).items()}
    want = jax_convert.ldm_unet_to_diffusers(ldm)
    got = convert.ldm_unet_to_diffusers({k: torch.from_numpy(v) for k, v in ldm.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    back = convert.diffusers_unet_to_ldm(got)
    assert set(back) == set(ldm)


@pytest.mark.parametrize("prefix,kind", [(convert.XL_CLIP_PREFIX, "clip"),
                                         (convert.XL_OPENCLIP_PREFIX, "openclip")])
def test_text_remaps_take_the_xl_prefixes_as_jax(single_file, prefix, kind):
    tensors, _ = loader.read_safetensors(str(single_file))
    np_sd = {k: v.numpy() for k, v in tensors.items()}
    if kind == "clip":
        got = convert.ldm_clip_to_hf(tensors, prefix=prefix)
        want = jax_convert.ldm_clip_to_hf(np_sd, prefix=prefix)
    else:
        got = convert.ldm_openclip_to_hf(tensors, prefix=prefix)
        want = jax_convert.ldm_openclip_to_hf(np_sd, hidden_size=TE2.hidden_size, prefix=prefix)
    assert got and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_sd_loader_refuses_an_sdxl_file(single_file):
    with pytest.raises(ValueError, match="load_models_xl"):
        loader.load_models(str(single_file))
    with pytest.raises(ValueError, match="load_models_xl"):
        jax_loader.load_models(str(single_file))


def test_xl_loader_refuses_an_sd_file_and_a_missing_tokenizer(single_file, tmp_path, tiny_xl):
    sd_file = testing.write_single_file_checkpoint(
        tmp_path / "sd" / "v2.safetensors", dataclasses.replace(
            testing.tiny_unet_config(32), layers_per_block=2, use_linear_projection=True),
        CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, hidden_act="gelu"), dtype=torch.float32)
    with pytest.raises(ValueError, match="does not look like an SDXL"):
        loader.load_models_xl(str(sd_file))
    lone = tmp_path / "lone" / "xl.safetensors"
    lone.parent.mkdir()
    lone.write_bytes(single_file.read_bytes())
    with pytest.raises(FileNotFoundError, match="tokenizer/"):
        loader.load_models_xl(str(lone))
    with pytest.raises(FileNotFoundError, match="not a local diffusers"):
        loader.load_models_xl(str(tmp_path / "nowhere"))


def test_single_file_writer_holds_one_tensor_at_a_time(tmp_path, monkeypatch):
    """write_sdxl_single_file draws each tensor as it is written: the
    largest tensor alive at once on the host is one of the file's."""
    from leco_tpu_torch import lora as port_lora

    sizes = []
    real = port_lora.write_safetensors

    def spy(path, tensors, metadata=None, fill=None):
        assert fill is not None and all(t.device.type == "meta" for t in tensors.values())

        def counted(name):
            t = fill(name)
            sizes.append(t.numel())
            return t

        return real(path, tensors, metadata, counted)

    monkeypatch.setattr(testing, "write_safetensors", spy)
    path = testing.write_sdxl_single_file(tmp_path / "xl.safetensors", TINY_XL, TE1, TE2)
    shapes = {k: v.shape for k, v in loader.read_safetensors(str(path))[0].items()}
    assert len(sizes) == len(shapes)
    assert (path.parent / "tokenizer_2" / "vocab.json").exists()


@pytest.mark.parametrize("cfg", [
    {"down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
     "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
     "block_out_channels": [320, 640, 1280], "transformer_layers_per_block": [1, 2, 10],
     "attention_head_dim": [5, 10, 20], "cross_attention_dim": 2048,
     "use_linear_projection": True, "addition_embed_type": "text_time",
     "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 2816},
    {"down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
     "up_block_types": ["CrossAttnUpBlock2D", "UpBlock2D"], "block_out_channels": [8, 16],
     "addition_embed_type": "text_time", "addition_time_embed_dim": None,
     "projection_class_embeddings_input_dim": None},
])
def test_xl_unet_config_from_json_matches_jax(cfg):
    got = dataclasses.asdict(loader.unet_config_from_json(cfg))
    assert got == dataclasses.asdict(jax_loader.unet_config_from_json(cfg))
    if len(cfg["block_out_channels"]) == 3:
        assert loader.unet_config_from_json(cfg) == sdxl_config().__class__(
            **{**dataclasses.asdict(sdxl_config()), "sample_size": 64})
