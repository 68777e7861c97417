"""The port's CLI, `python -m leco_tpu_torch.train_lora --config_file <yaml>
--device cpu`, end to end on a tiny diffusers checkpoint written by
`leco_tpu_torch.testing`: YAML config and prompts, tokenizer, CLIP, loader,
a v-prediction DDIM train with `use_flash_attention: true` and
LECO_FLASH_PACKED=1 at 128 px (the tiny UNet's level 0 has 256 tokens and
takes the packed route), metrics.jsonl and the AddNet export in the JAX
package's layout."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from leco_tpu import lora as jax_lora
from leco_tpu.models.convert import _fold_path
from leco_tpu_torch import testing
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.unet import tiny_unet_config
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.train_lora import main, parse_args
from tests.test_torch_port_train_step import _flax_layout

REPO = Path(__file__).resolve().parents[1]
ITERATIONS, MAX_STEPS = 2, 3


def write_run(tmp: Path, ckpt: Path, extra_train: str = "", logging: str = "") -> Path:
    (tmp / "prompts.yaml").write_text(
        "# the van-gogh recipe at 128 px\n"
        "- target: \"van gogh\"\n  positive: \"van gogh\"\n  unconditional: \"\"\n"
        "  neutral: \"\"\n  action: \"erase\"\n  guidance_scale: 1.0\n"
        "  resolution: 128\n  batch_size: 1\n")
    config = tmp / "config.yaml"
    config.write_text(f"""\
prompts_file: "{tmp / 'prompts.yaml'}"
pretrained_model:
  name_or_path: "{ckpt}"
  v2: true
  v_pred: true
network:
  type: "lierla"
  rank: 4
  alpha: 1.0
train:
  precision: "float32"
  noise_scheduler: "ddim"
  iterations: {ITERATIONS}
  lr: 1e-4
  max_denoising_steps: {MAX_STEPS}
  seed: 0
  data_parallel: true{extra_train}
save:
  name: "tiny_cli"
  path: "{tmp / 'out'}"
  per_steps: 200
  precision: "float32"
other:
  use_flash_attention: true
{logging}""")
    return config


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    text = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, hidden_act="gelu")
    return testing.write_diffusers_checkpoint(tmp_path_factory.mktemp("ckpt"),
                                              tiny_unet_config(32), text, seed=7)


def test_cli_trains_on_the_packed_route(checkpoint, tmp_path, monkeypatch):
    monkeypatch.setenv("LECO_FLASH_PACKED", "1")
    calls = {"packed": 0, "3d": 0}
    real_packed, real_3d = fa.attn_fwd_packed_plain, fa.attn_fwd_plain

    def packed(*a):
        calls["packed"] += 1
        return real_packed(*a)

    def three_d(*a):
        calls["3d"] += 1
        return real_3d(*a)

    monkeypatch.setattr(fa, "attn_fwd_packed_plain", packed)
    monkeypatch.setattr(fa, "attn_fwd_plain", three_d)
    result = main(parse_args(["--config_file", str(write_run(tmp_path, checkpoint)),
                              "--device", "cpu"]))
    assert len(result["losses"]) == ITERATIONS and all(np.isfinite(result["losses"]))

    out = tmp_path / "out"
    records = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    rng = np.random.default_rng(0)  # the host stream: (pair, timesteps_to) draws
    tsto = []
    for i, r in enumerate(records):
        assert int(rng.integers(0, 1)) == 0
        tsto.append(int(rng.integers(1, MAX_STEPS)))
        assert (r["iteration"], r["timesteps_to"], r["resolution"]) == (i, tsto[-1], [128, 128])
    # 3 level-0 self-attentions per UNet forward, t_to + 2 forwards per step
    assert calls == {"packed": 3 * sum(t + 2 for t in tsto), "3d": 0}

    tree = {_fold_path(k.rsplit(".", 1)[0]) + (k.rsplit(".", 1)[1],): _flax_layout(k, v)
            for k, v in result["lora"].items()}
    want = jax_lora.export_lora_state(unflatten_dict(tree), jax_lora.LoRASpec(4, 1.0))
    from safetensors.numpy import load_file

    got = load_file(str(out / "tiny_cli_last.safetensors"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_module_refuses_cuda_without_a_gpu(checkpoint, tmp_path):
    """`--device` defaults to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "leco_tpu_torch.train_lora", "--config_file",
         str(write_run(tmp_path, checkpoint))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("option,message,error", [
    pytest.param("step_chunk: 2", "train.step_chunk > 1", NotImplementedError,
                 id="step_chunk: 2-train.step_chunk > 1"),
    pytest.param("tensor_parallel: 2", "train.tensor_parallel > 1", ValueError,
                 id="tensor_parallel: 2-train.tensor_parallel > 1"),
    pytest.param("spatial_parallel: 2", "train.spatial_parallel != 1", ValueError,
                 id="spatial_parallel: 2-train.spatial_parallel != 1"),
])
def test_cli_refuses_unported_options_before_loading(tmp_path, option, message, error):
    """Refused before the checkpoint is read: the JAX package's device-side
    step chunking (not ported), and a tp or sp mesh that one process cannot
    hold (tp 2 or sp 2 need a world size they divide: torchrun's)."""
    config = write_run(tmp_path, tmp_path / "not-there", f"\n  {option}")
    with pytest.raises(error, match=message.replace(">", ".").replace("!", ".")):
        main(parse_args(["--config_file", str(config), "--device", "cpu"]))


PARALLEL_WITHOUT_JAX = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "leco_tpu"):
    sys.modules[name] = None  # any import of it raises ImportError
import leco_tpu_torch.parallel as parallel
names = [m.name for m in pkgutil.walk_packages(parallel.__path__, "leco_tpu_torch.parallel.")]
for name in names:
    importlib.import_module(name)
from leco_tpu_torch.parallel import distributed, mesh
assert distributed.shared_seed(None) is None and mesh.mesh_axes(True, 1, 0, 4) == ("sp", 2)
print("PARALLEL OK", sorted(names))
"""


def test_parallel_modules_import_without_jax():
    """Every module of `leco_tpu_torch.parallel` (the rank workers included)
    imports and runs its rules with JAX and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", PARALLEL_WITHOUT_JAX], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PARALLEL OK" in proc.stdout
    for module in ("collectives", "context", "distributed", "mesh", "sharding", "spatial",
                   "testing"):
        assert f"leco_tpu_torch.parallel.{module}" in proc.stdout


def test_cli_trains_a_tiny_unreal_recipe(checkpoint, tmp_path):
    """`python -m leco_tpu_torch.train_lora --device cpu` on a tiny copy of
    examples/unreal_config.yaml (Lion, cosine, rank 16, the 12-pair
    multi-resolution prompts at 128/192/256 px) with this slice's options:
    lms, save_state, ema_decay and checkpoint_unet."""
    from leco_tpu_torch.train.checkpoint import latest_step
    from leco_tpu_torch.train.optim import get_lr_schedule
    from leco_tpu_torch.utils import yaml_subset

    config = yaml_subset.load(REPO / "examples" / "unreal_config.yaml")
    assert (config["train"]["optimizer"], config["train"]["lr_scheduler"]) == ("lion", "cosine")
    prompts = (REPO / "examples" / "unreal_prompts.yaml").read_text()
    for big, small in (("512", "128"), ("640", "192"), ("768", "256")):
        prompts = prompts.replace(f"resolution: {big}", f"resolution: {small}")
    (tmp_path / "prompts.yaml").write_text(prompts)
    config["prompts_file"] = str(tmp_path / "prompts.yaml")
    config["pretrained_model"].update(name_or_path=str(checkpoint), v2=False, v_pred=False)
    config["train"].update(iterations=3, max_denoising_steps=3, seed=0, precision="float32",
                           noise_scheduler="lms", save_state=True, ema_decay=0.999,
                           checkpoint_unet=True)
    config["save"].update(path=str(tmp_path / "out"), per_steps=1)
    config["logging"].update(verbose=False)
    lines = [f"prompts_file: {json.dumps(config.pop('prompts_file'))}"]
    for section, values in config.items():
        lines += [f"{section}:"] + [f"  {k}: {json.dumps(v)}" for k, v in values.items()]
    (tmp_path / "config.yaml").write_text("\n".join(lines) + "\n")

    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "leco_tpu_torch.train_lora", "--config_file",
         str(tmp_path / "config.yaml"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("Done.")
    out = tmp_path / "out"
    records = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    lr_at = get_lr_schedule("cosine", 1e-4, 3)
    assert [r["lr"] for r in records] == [lr_at(j) for j in range(3)]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert {r["resolution"][0] for r in records} <= {128, 192, 256}
    assert latest_step(out / "state") == 1
    for name in ("unreal_1steps", "unreal_1steps_ema", "unreal_last", "unreal_last_ema"):
        assert (out / f"{name}.safetensors").exists(), name


def test_cli_trains_with_use_wandb_when_wandb_is_missing(checkpoint, tmp_path, monkeypatch,
                                                        capsys):
    """As the JAX trainer does: wandb cannot be imported, so the run says so
    and trains on (examples/cat_ears_config.yaml sets use_wandb)."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    config = write_run(tmp_path, checkpoint, logging="logging:\n  use_wandb: true\n")
    result = main(parse_args(["--config_file", str(config), "--device", "cpu"]))
    assert len(result["losses"]) == ITERATIONS and all(np.isfinite(result["losses"]))
    assert (tmp_path / "out" / "tiny_cli_last.safetensors").exists()
    assert "wandb not installed; continuing without it" in capsys.readouterr().out


def test_cli_logs_loss_iteration_and_lr_to_wandb(checkpoint, tmp_path, monkeypatch):
    calls = {"init": [], "log": [], "finish": 0}

    class Run:
        def log(self, record):
            calls["log"].append(record)

        def finish(self):
            calls["finish"] += 1

    def init(**kwargs):
        calls["init"].append(kwargs)
        return Run()

    fake = types.ModuleType("wandb")
    fake.init = init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    config = write_run(tmp_path, checkpoint, logging="logging:\n  use_wandb: true\n")
    result = main(parse_args(["--config_file", str(config), "--device", "cpu"]))
    (init_kwargs,) = calls["init"]
    assert init_kwargs["project"] == "LECO_tiny_cli"
    assert set(init_kwargs["config"]) == {"prompts", "config"}
    assert [r["iteration"] for r in calls["log"]] == list(range(ITERATIONS))
    assert all(set(r) == {"loss", "iteration", "lr"} and r["lr"] == 1e-4 for r in calls["log"])
    assert [r["loss"] for r in calls["log"]] == result["losses"]
    assert calls["finish"] == 1
