"""The port's textual-inversion CLI, `python -m leco_tpu_torch.train_ti
--config_file <yaml> --device cpu`, end to end on a tiny diffusers
checkpoint written by `leco_tpu_torch.testing` (YAML, tokenizer, CLIP,
loader without LoRA layers, the train loop, the A1111 export); `--device
cuda` without a GPU raises before anything loads."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from leco_tpu_torch import testing
from leco_tpu_torch.lora import read_safetensors
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.unet import tiny_unet_config
from leco_tpu_torch.train_ti import main, parse_args

REPO = Path(__file__).resolve().parents[1]
ITERATIONS = 2


def write_run(tmp: Path, ckpt: Path) -> Path:
    (tmp / "prompts.yaml").write_text(
        "- target: \"van gogh\"\n  positive: \"van gogh\"\n  unconditional: \"\"\n"
        "  neutral: \"\"\n  action: \"erase\"\n  guidance_scale: 1.0\n"
        "  resolution: 64\n  batch_size: 1\n")
    config = tmp / "config.yaml"
    config.write_text(f"""\
prompts_file: "{tmp / 'prompts.yaml'}"
pretrained_model:
  name_or_path: "{ckpt}"
network:
  rank: 4    # unused by TI
train:
  precision: "float32"
  noise_scheduler: "ddim"
  iterations: {ITERATIONS}
  lr: 5e-3
  optimizer: "AdamW"
  lr_scheduler: "constant"
  max_denoising_steps: 3
  seed: 0
save:
  name: "tiny_ti"
  path: "{tmp / 'out'}"
  per_steps: 200
  precision: "bfloat16"
""")
    return config


def test_cli_trains_an_embedding(tmp_path):
    text = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2)
    ckpt = testing.write_diffusers_checkpoint(tmp_path / "ckpt", tiny_unet_config(32), text,
                                              seed=7)
    config = write_run(tmp_path, ckpt)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "leco_tpu_torch.train_ti", "--config_file", str(config),
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "out"
    final = out / "tiny_ti_ti.safetensors"
    assert f"saved: {[str(final)]}" in proc.stdout
    assert f"{ITERATIONS}/{ITERATIONS} Loss*1k: " in proc.stdout
    records = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in records] == list(range(ITERATIONS))
    assert all(r["lr"] == 5e-3 and r["loss"] > 0 for r in records)
    state, metadata = read_safetensors(final)
    assert list(state) == ["emb_params"]
    emb = state["emb_params"]
    assert emb.dtype == torch.bfloat16 and emb.shape == (2, 32)  # "van gogh": 2 tokens
    assert bool(torch.isfinite(emb.float()).all())
    assert metadata["name"] == "tiny_ti" and metadata["target"] == "van gogh"
    assert json.loads(metadata["config"])["save"]["precision"] == "bfloat16"


def test_cuda_is_refused_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(parse_args(["--config_file", str(tmp_path / "missing.yaml")]))
