"""The port's config tree, prompt schema and ESD loss against the JAX
package's, and a run of the port's main path and of its CLI with every
package outside torch, numpy and einops blocked (a GPU deployment has no
pydantic, yaml, safetensors, tqdm, regex or PIL)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from leco_tpu import config as jax_config
from leco_tpu import prompts as jax_prompts
from leco_tpu_torch import config, prompts

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


@pytest.mark.parametrize(
    "name", ["config.yaml", "cat_ears_config.yaml", "config_xl.yaml",
             "unreal_config.yaml", "ti_config.yaml"]
)
def test_config_matches_jax_model_dump(name):
    raw = yaml.safe_load((EXAMPLES / name).read_text())
    want = jax_config.RootConfig(**raw)
    for section in ("train", "save", "logging", "other"):  # as load_config_from_yaml
        if getattr(want, section) is None:
            setattr(want, section, getattr(jax_config, {
                "train": "TrainConfig", "save": "SaveConfig",
                "logging": "LoggingConfig", "other": "OtherConfig"}[section])())
    got = config.RootConfig.from_dict(raw)
    assert got.to_dict() == want.model_dump()
    assert config.load_config_from_yaml(str(EXAMPLES / name)).to_dict() == want.model_dump()


@pytest.mark.parametrize(
    "name", ["prompts.yaml", "cat_ears_prompts.yaml", "prompts_xl.yaml",
             "unreal_prompts.yaml"]
)
def test_prompts_match_jax_model_dump(name):
    got = prompts.load_prompts_from_yaml(EXAMPLES / name)
    want = jax_prompts.load_prompts_from_yaml(EXAMPLES / name)
    assert [p.to_dict() for p in got] == [p.model_dump() for p in want]


@pytest.mark.parametrize(
    "entry",
    [
        {"target": "a"},  # fills: positive <- target, neutral <- unconditional
        {"target": "a", "unconditional": "u"},
        {"target": "a", "positive": "b", "neutral": "n", "action": "enhance",
         "guidance_scale": "2.5", "resolution": 768, "unknown_key": 1},
    ],
)
def test_prompt_fills_and_ignored_keys(entry):
    got = prompts.PromptSettings.from_dict(entry).to_dict()
    assert got == jax_prompts.PromptSettings(**entry).model_dump()


def test_schema_errors():
    with pytest.raises(ValueError):
        prompts.PromptSettings.from_dict({"positive": "x"})  # no target
    with pytest.raises(ValueError):
        prompts.PromptSettings.from_dict({"target": "a", "action": "blur"})
    with pytest.raises(ValueError):
        config.RootConfig.from_dict({"prompts_file": "p"})  # no pretrained_model
    with pytest.raises(ValueError):
        config.RootConfig.from_dict({"prompts_file": "p",
                                     "pretrained_model": {"name_or_path": "m"},
                                     "train": {"precision": "fp64"}})


@pytest.mark.parametrize(
    "precision,want",
    [("fp32", torch.float32), ("float32", torch.float32), ("fp16", torch.float16),
     ("float16", torch.float16), ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16)],
)
def test_parse_precision(precision, want):
    assert config.parse_precision(precision) is want
    assert str(jax_config.parse_precision(precision).dtype) == str(want).split(".")[1]


@pytest.mark.parametrize("action,sign", [("erase", 1.0), ("enhance", -1.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esd_loss_matches_jax(action, sign, dtype):
    rng = np.random.default_rng(0)
    preds = [rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(4)]
    settings = prompts.PromptSettings.from_dict({"target": "a", "action": action,
                                                 "guidance_scale": 3.0})
    pair = prompts.PromptEmbedsPair(None, None, None, None, settings)
    assert pair.erase_sign == sign
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = pair.loss(
        target_latents=torch.from_numpy(preds[0]).to(tdt),
        positive_latents=torch.from_numpy(preds[1]).to(tdt),
        unconditional_latents=torch.from_numpy(preds[2]).to(tdt),
        neutral_latents=torch.from_numpy(preds[3]).to(tdt),
    )
    want = jax_prompts.esd_loss(*(jnp.asarray(p).astype(jdt) for p in preds), 3.0, sign)
    assert got.dtype == torch.float32  # the loss is fp32 whatever the model dtype
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


BLOCKED = ("jax", "flax", "optax", "orbax", "pydantic", "yaml", "safetensors", "tqdm", "regex",
           "PIL", "leco_tpu")

MAIN_PATH_WITHOUT_EXTRAS = textwrap.dedent(
    """
    import importlib, pkgutil, sys, tempfile
    for name in {blocked!r}:
        sys.modules[name] = None  # any import of it raises ImportError
    import leco_tpu_torch
    for mod in pkgutil.walk_packages(leco_tpu_torch.__path__, "leco_tpu_torch."):
        importlib.import_module(mod.name)
        print("IMPORTED", mod.name)
    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_random_bundle
    from leco_tpu_torch.train.trainer import train
    with tempfile.TemporaryDirectory() as out:
        cfg = RootConfig.from_dict({{
            "prompts_file": "p", "pretrained_model": {{"name_or_path": "m"}},
            "train": {{"iterations": 1, "max_denoising_steps": 2, "seed": 0}},
            "save": {{"name": "t", "path": out}},
        }})
        r = train(cfg, [PromptSettings.from_dict({{"target": "a", "resolution": 64}})],
                  make_random_bundle(attn_backend="flash"))
        assert len(r["losses"]) == 1 and len(r["saved"]) == 1, r
    print("MAIN PATH OK")

    # the CLI on a tiny checkpoint: YAML, tokenizer, CLIP, loader, packed route
    import os
    from pathlib import Path
    from leco_tpu_torch import testing
    from leco_tpu_torch.models.clip import CLIPTextConfig
    from leco_tpu_torch.models.unet import tiny_unet_config
    from leco_tpu_torch.train_lora import main, parse_args
    os.environ["LECO_FLASH_PACKED"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        testing.write_diffusers_checkpoint(tmp / "ckpt", tiny_unet_config(32), CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2))
        (tmp / "prompts.yaml").write_text("- target: 'van gogh'\\n  resolution: 128\\n")
        (tmp / "config.yaml").write_text(
            f"prompts_file: '{{tmp / 'prompts.yaml'}}'\\n"
            f"pretrained_model:\\n  name_or_path: '{{tmp / 'ckpt'}}'\\n  v_pred: true\\n"
            "train:\\n  iterations: 1\\n  max_denoising_steps: 2\\n  seed: 0\\n  lr: 1e-4\\n"
            f"save:\\n  name: t\\n  path: '{{tmp / 'out'}}'\\n"
            "other:\\n  use_flash_attention: true\\n")
        r = main(parse_args(["--config_file", str(tmp / "config.yaml"), "--device", "cpu"]))
        assert len(r["losses"]) == 1 and (tmp / "out" / "t_last.safetensors").exists(), r
        print("CLI OK")

        # textual inversion through its CLI on the same files, and the utilities
        from leco_tpu_torch.flush import flush
        from leco_tpu_torch.train_ti import main as ti_main
        from leco_tpu_torch.utils.profiling import StepTimer, trace_if
        timer = StepTimer(warmup=0)
        with trace_if(str(tmp / "trace")):
            r = ti_main(parse_args(["--config_file", str(tmp / "config.yaml"), "--device", "cpu"]),
                        on_step=timer)
        assert len(r["losses"]) == 1 and (tmp / "out" / "t_ti.safetensors").exists(), r
        assert (tmp / "trace" / "trace.json").exists() and timer.summary()
        flush()
    print("TI CLI OK")

    # inference and eval on tiny dirs: generate, decode, PNG, CLIP score
    from leco_tpu_torch import infer
    from leco_tpu_torch.eval import CLIPScorer
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.models.clip_vision import tiny_vision_config
    from leco_tpu_torch.models.loader import load_models, load_vae_decoder
    from leco_tpu_torch.models.vae import VAEDecoderConfig
    text = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        testing.write_diffusers_checkpoint(tmp / "sd", tiny_unet_config(32), text)
        testing.write_vae_dir(tmp / "sd", VAEDecoderConfig(
            block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4))
        testing.write_clip_dir(tmp / "clip", text, tiny_vision_config(), projection_dim=16)
        models = load_models(str(tmp / "sd"), lora_spec=LoRASpec(rank=2), device="cpu")
        latents = infer.generate_latents(models, "van gogh", "", infer.GenerationConfig(
            height=64, width=64, num_inference_steps=2))
        images = infer.decode_latents(models, latents, load_vae_decoder(str(tmp / "sd"),
                                                                        device="cpu"))
        assert images.shape == (1, 64, 64, 3), images.shape
        assert infer.save_images(images, str(tmp / "img"))
        score = CLIPScorer.from_pretrained(str(tmp / "clip"), device="cpu").score(
            images, ["van gogh"])
        assert score.shape == (1,), score
    print("INFER OK")
    """
).format(blocked=BLOCKED)


def test_main_path_runs_with_torch_numpy_einops_only():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", MAIN_PATH_WITHOUT_EXTRAS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MAIN PATH OK" in proc.stdout and "CLI OK" in proc.stdout
    assert "TI CLI OK" in proc.stdout and "INFER OK" in proc.stdout
    for module in ("bench", "utils.benchkit", "scripts.bench_full", "scripts.bench_xl",
                   "scripts.profile_step", "scripts.profile_unet", "scripts.profile_fwd",
                   "scripts.bench_convs", "scripts.bench_pallas_conv", "scripts.ab_convfold"):
        assert f"IMPORTED leco_tpu_torch.{module}\n" in proc.stdout
