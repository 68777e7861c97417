"""The port's eval harness and scripts against the JAX package's.

`erased_concept_delta` on one pair of fake generate / decode functions and
one stub scorer in both packages (equal to 1e-12: the same arithmetic in
float64); `merge_lora_into_state` against `scripts/merge_lora.py`'s
`merge_lora_into_torch_sd` on the same numpy state (fp32 within 1e-6: one
GEMM, summed in another order); `eval_clip_score --device cpu` end to end
on tiny directories; the PNG writer read back; bench_quality's
signatures."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from leco_tpu import eval as jax_eval
from leco_tpu_torch import eval as port_eval
from leco_tpu_torch import infer, lora, testing
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.clip_vision import tiny_vision_config
from leco_tpu_torch.models.unet import UNet2DConditionModel, tiny_unet_config
from leco_tpu_torch.models.vae import VAEDecoderConfig
from leco_tpu_torch.scripts import bench_quality, eval_clip_score, merge_lora

REPO = os.path.join(os.path.dirname(__file__), "..")


def _jax_merge_module():
    path = os.path.join(REPO, "scripts", "merge_lora.py")
    spec = importlib.util.spec_from_file_location("jax_merge_lora", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("prompts", [None, ["van gogh", "a starry night by van gogh"]])
def test_erased_concept_delta_matches_jax(prompts):
    class StubScorer:
        def score(self, images, texts):
            return np.asarray(images).reshape(len(images), -1).mean(axis=1)

    def generate_fn(prompt, seed, multiplier):
        rng = np.random.default_rng(seed + len(prompt))
        return rng.standard_normal((2, 4, 4, 3)) + 50.0 - 20.0 * multiplier

    def decode_fn(latents):
        return np.clip(latents, 0, 255)

    args = dict(prompts=prompts, seeds=(0, 1, 2), multiplier=1.0)
    got = port_eval.erased_concept_delta(StubScorer(), decode_fn, generate_fn, "van gogh", **args)
    want = jax_eval.erased_concept_delta(StubScorer(), decode_fn, generate_fn, "van gogh", **args)
    assert got.keys() == want.keys() == {"base", "erased", "delta"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    assert got["delta"] == pytest.approx(20.0, abs=0.5)


@pytest.mark.parametrize("network", ["lierla", "c3lier"])
def test_merge_lora_matches_jax(network, capsys):
    unet = UNet2DConditionModel(tiny_unet_config())
    gen = torch.Generator().manual_seed(0)
    testing.init_unet_(unet, gen, torch.float32)
    spec = lora.LoRASpec(rank=4, alpha=2.0, network_type=network)
    lora.apply_lora_spec(unet, spec, gen)
    rng = np.random.default_rng(1)
    tree = {k: torch.from_numpy((0.05 * rng.standard_normal(v.shape)).astype(np.float32))
            for k, v in lora.lora_parameters(unet).items()}
    base, _ = lora.split_lora_params(unet.state_dict())
    lora_state = lora.export_lora_state(tree, spec)
    got = merge_lora.merge_lora_into_state(base, lora_state, multiplier=-0.5)
    want = _jax_merge_module().merge_lora_into_torch_sd(
        {k: v.numpy() for k, v in base.items()}, {k: v.numpy() for k, v in lora_state.items()},
        multiplier=-0.5)
    assert got.keys() == want.keys()
    changed = 0
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-6, err_msg=k)
        changed += not torch.equal(v, base[k])
    assert changed == lora.count_lora_modules(tree)
    assert "merged" in capsys.readouterr().out


def test_merge_lora_refuses_an_unknown_layer():
    state = {"conv_in.weight": torch.zeros(8, 4, 3, 3)}
    lora_state = {"lora_unet_nowhere.lora_down.weight": torch.zeros(2, 4),
                  "lora_unet_nowhere.lora_up.weight": torch.zeros(4, 2)}
    with pytest.raises(KeyError, match="cannot resolve"):
        merge_lora.merge_lora_into_state(state, lora_state)


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    """A tiny SD checkpoint with its vae/, a tiny CLIP dir and a LoRA file."""
    root = tmp_path_factory.mktemp("eval")
    sd = testing.write_diffusers_checkpoint(
        root / "sd", tiny_unet_config(32),
        CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2), seed=2)
    testing.write_vae_dir(sd, VAEDecoderConfig(block_out_channels=(8, 8, 16, 16),
                                               layers_per_block=1, norm_num_groups=4), seed=3)
    clip = testing.write_clip_dir(
        root / "clip", CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=2),
        tiny_vision_config(), projection_dim=16, seed=4)
    unet = UNet2DConditionModel(tiny_unet_config(32))
    spec = lora.LoRASpec(rank=4, alpha=1.0)
    lora.apply_lora_spec(unet, spec, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    tree = {k: torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
            for k, v in lora.lora_parameters(unet).items()}
    lora.save_lora_weights(root / "erase.safetensors", tree, spec)
    return dict(sd=sd, clip=clip, lora=root / "erase.safetensors", root=root)


def test_eval_clip_score_runs_on_the_cpu(tiny_dirs, capsys):
    record = eval_clip_score.main([
        "--model", str(tiny_dirs["sd"]), "--clip", str(tiny_dirs["clip"]),
        "--lora", str(tiny_dirs["lora"]), "--concept", "van gogh", "--seeds", "0",
        "--steps", "2", "--resolution", "64", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == record
    assert record["concept"] == "van gogh"
    assert all(np.isfinite(record[k]) for k in ("base", "erased", "delta"))
    assert record["delta"] == pytest.approx(record["base"] - record["erased"])


def test_merge_lora_script_writes_a_loadable_unet(tiny_dirs, capsys):
    out = tiny_dirs["root"] / "merged.safetensors"
    merge_lora.main(["--model", str(tiny_dirs["sd"]), "--lora", str(tiny_dirs["lora"]),
                     "--out", str(out), "--device", "cpu"])
    merged, _ = lora.read_safetensors(out)
    base, _ = lora.read_safetensors(tiny_dirs["sd"] / "unet" / "diffusion_pytorch_model.safetensors")
    assert merged.keys() == base.keys()
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert not torch.equal(merged[key], base[key])
    assert torch.equal(merged["conv_in.weight"], base["conv_in.weight"])
    assert f"wrote {out}" in capsys.readouterr().out


def test_scripts_refuse_a_missing_gpu(tiny_dirs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        merge_lora.main(["--model", str(tiny_dirs["sd"]), "--lora", str(tiny_dirs["lora"]),
                         "--out", str(tiny_dirs["root"] / "x.safetensors")])


def test_png_writer_reads_back(tmp_path):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    paths = infer.save_images(images, str(tmp_path / "out"))
    assert paths == [str(tmp_path / f"out_{i}.png") for i in range(2)]
    for path, img in zip(paths, images):
        with Image.open(path) as im:
            assert im.mode == "RGB" and im.size == (7, 5)
            np.testing.assert_array_equal(np.asarray(im), img)


def test_bench_quality_signatures_are_orthonormal():
    sig, sig_n = bench_quality.signatures()
    assert sig.shape == bench_quality.LATENT_SHAPE
    assert np.linalg.norm(sig) == pytest.approx(1.0, abs=1e-6)
    assert np.linalg.norm(sig_n) == pytest.approx(1.0, abs=1e-6)
    assert abs(float(np.sum(sig * sig_n))) < 1e-6
    assert bench_quality.DELTA_BAR == 0.5 and bench_quality.ITERATIONS == 150
