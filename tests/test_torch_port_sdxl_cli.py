"""The port's SDXL CLI, `python -m leco_tpu_torch.train_lora_xl --config_file
<yaml> --device cpu`, end to end on a tiny SDXL diffusers directory written
by `leco_tpu_torch.testing`: YAML config and prompts, both tokenizers and
text encoders, the XL loader, a DDIM train with `use_flash_attention: true`
at 256 px (the tiny UNet's level 1 has 256 tokens: the flash route) with
dynamic crops, metrics.jsonl and the AddNet export. `--device` defaults to
cuda and raises without a GPU; unported options are refused before any
weight loads; and the XL modules run with JAX and the JAX package blocked."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from leco_tpu_torch.lora import read_safetensors
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.train.diffusion import get_add_time_ids
from leco_tpu_torch.train_lora import parse_args
from leco_tpu_torch.train_lora_xl import main
from tests.test_torch_port_config_prompts import BLOCKED
from tests.test_torch_port_sdxl_loader import write_tiny_xl_dir

REPO = Path(__file__).resolve().parents[1]
ITERATIONS, MAX_STEPS = 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_run(tmp: Path, ckpt: Path, extra_train: str = "") -> Path:
    (tmp / "prompts.yaml").write_text(
        "# the van-gogh XL recipe at 256 px, with dynamic crops\n"
        "- target: \"van gogh\"\n  positive: \"van gogh\"\n  unconditional: \"\"\n"
        "  neutral: \"\"\n  action: \"erase\"\n  guidance_scale: 1.0\n"
        "  resolution: 256\n  dynamic_crops: true\n  batch_size: 1\n")
    config = tmp / "config.yaml"
    config.write_text(f"""\
prompts_file: "{tmp / 'prompts.yaml'}"
pretrained_model:
  name_or_path: "{ckpt}"
network:
  type: "lierla"
  rank: 4
  alpha: 1.0
  training_method: "full"
train:
  precision: "float32"
  noise_scheduler: "ddim"
  iterations: {ITERATIONS}
  lr: 1e-4
  optimizer: "AdamW"
  max_denoising_steps: {MAX_STEPS}
  seed: 0{extra_train}
save:
  name: "tiny_xl"
  path: "{tmp / 'out'}"
  per_steps: 200
  precision: "bfloat16"
other:
  use_flash_attention: true
""")
    return config


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_xl_dir(tmp_path_factory.mktemp("xl_cli"), seed=17)


def test_cli_module_trains_and_saves(checkpoint, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "leco_tpu_torch.train_lora_xl", "--config_file",
         str(write_run(tmp_path, checkpoint)), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Loss*1k" in proc.stdout and "Done." in proc.stdout
    out = tmp_path / "out"
    records = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    rng = np.random.default_rng(0)  # the host stream: pair, timesteps_to, the crops
    for i, r in enumerate(records):
        assert int(rng.integers(0, 1)) == 0
        assert (r["iteration"], r["timesteps_to"], r["resolution"]) == (
            i, int(rng.integers(1, MAX_STEPS)), [256, 256])
        get_add_time_ids(256, 256, dynamic_crops=True, rng=rng)  # the crop's draws
    assert len(records) == ITERATIONS
    state, metadata = read_safetensors(out / "tiny_xl_last.safetensors")
    assert state and all(v.dtype == torch.bfloat16 for k, v in state.items()
                         if not k.endswith(".alpha"))
    assert any(k.startswith("lora_unet_down_blocks_2_attentions_1_transformer_blocks_2_")
               for k in state)
    assert json.loads(metadata["prompts"].split(",{")[0])["dynamic_crops"] is True


def test_cli_takes_the_flash_route_and_checkpoint_unet(checkpoint, tmp_path, monkeypatch):
    """In process: level 1's 10 self-attentions (256 tokens) take the 3-d
    kernels' plain versions, t_to + 2 forwards a step and the target pass
    once more for its recomputation under checkpoint_unet."""
    calls = {"fwd": 0, "dq": 0}
    real_fwd, real_dq = fa.attn_fwd_plain, fa.attn_bwd_dq_plain
    monkeypatch.setattr(fa, "attn_fwd_plain",
                        lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or real_fwd(*a))
    monkeypatch.setattr(fa, "attn_bwd_dq_plain",
                        lambda *a: calls.__setitem__("dq", calls["dq"] + 1) or real_dq(*a))
    config = write_run(tmp_path, checkpoint, "\n  checkpoint_unet: true")
    result = main(parse_args(["--config_file", str(config), "--device", "cpu"]))
    assert len(result["losses"]) == ITERATIONS and all(np.isfinite(result["losses"]))
    tsto = [json.loads(ln)["timesteps_to"]
            for ln in (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert calls == {"fwd": 10 * sum(t + 3 for t in tsto), "dq": 10 * ITERATIONS}


def test_cli_module_refuses_cuda_without_a_gpu(checkpoint, tmp_path):
    """`--device` defaults to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "leco_tpu_torch.train_lora_xl", "--config_file",
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
    """Refused before the checkpoint is read: step chunking (not ported), tp
    2 on one process (it needs a world size it divides), and sp (SDXL takes
    data and tensor parallelism only)."""
    config = write_run(tmp_path, tmp_path / "not-there", f"\n  {option}")
    with pytest.raises(error, match=message.replace(">", ".").replace("!", ".")):
        main(parse_args(["--config_file", str(config), "--device", "cpu"]))


XL_WITHOUT_EXTRAS = textwrap.dedent(
    """
    import os, sys, tempfile
    for name in {blocked!r}:
        sys.modules[name] = None  # any import of it raises ImportError
    from pathlib import Path
    from leco_tpu_torch import testing
    from leco_tpu_torch.models.clip import CLIPTextConfig
    from leco_tpu_torch.models.vae import VAEDecoderConfig
    from leco_tpu_torch.scripts import infer_xl
    from leco_tpu_torch.train_lora import parse_args
    from leco_tpu_torch.train_lora_xl import main
    te1 = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2)
    te2 = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2, hidden_act="gelu", projection_dim=8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        testing.write_sdxl_single_file(tmp / "xl" / "tiny.safetensors",
                                       testing.tiny_xl_unet_config(), te1, te2)
        testing.write_sdxl_diffusers_checkpoint(tmp / "dir", testing.tiny_xl_unet_config(),
                                                te1, te2)
        testing.write_vae_dir(tmp / "dir", VAEDecoderConfig(
            block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4))
        (tmp / "prompts.yaml").write_text("- target: 'van gogh'\\n  resolution: 64\\n")
        (tmp / "config.yaml").write_text(
            f"prompts_file: '{{tmp / 'prompts.yaml'}}'\\n"
            f"pretrained_model:\\n  name_or_path: '{{tmp / 'dir'}}'\\n"
            "train:\\n  iterations: 1\\n  max_denoising_steps: 2\\n  seed: 0\\n"
            "  precision: float32\\n"
            f"save:\\n  name: t\\n  path: '{{tmp / 'out'}}'\\n")
        r = main(parse_args(["--config_file", str(tmp / "config.yaml"), "--device", "cpu"]))
        assert len(r["losses"]) == 1 and (tmp / "out" / "t_last.safetensors").exists(), r
        print("XL CLI OK")
        os.chdir(tmp)
        infer_xl.HEIGHT = infer_xl.WIDTH = 64
        infer_xl.DDIM_STEPS = 2
        paths = infer_xl.main([str(tmp / "dir"), "--device", "cpu"])
        assert (tmp / paths[0]).read_bytes()[:4] == b"\\x89PNG", paths
        print("INFER XL OK")
    """
).format(blocked=BLOCKED)


def test_xl_modules_run_without_jax_or_the_jax_package():
    """The XL CLI and `scripts/infer_xl.py` (writers, both loaders' XL
    routes, training, generation, the PNG) with jax, flax, optax, PyYAML,
    safetensors, PIL and `leco_tpu` unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", XL_WITHOUT_EXTRAS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "XL CLI OK" in proc.stdout and "INFER XL OK" in proc.stdout
