"""The port's utilities: `utils/profiling.py` (`StepTimer`, `trace_if` on
torch.profiler) against the JAX package's, `flush`, and the native BPE
merge engine (`leco_tpu_torch/native/`) against the pure-Python merge loop
on the synthetic vocabulary."""

import json

import numpy as np
import pytest
import torch

from leco_tpu.utils import profiling as jax_profiling
from leco_tpu_torch import native, testing
from leco_tpu_torch.flush import flush
from leco_tpu_torch.models.tokenizer import CLIPTokenizer
from leco_tpu_torch.utils import profiling

PROMPTS = ["van gogh", "cat ears", "a van", "gogh gogh gogh", "realistic, real life",
           "instagram 1girl", "an unmerged zebra", "<|endoftext|> van", ""]


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 2.0, 2.5, 3.25, 4.5, 0.0, 2.0, 2.5, 3.25, 4.5])
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    ours, theirs = profiling.StepTimer(warmup=1), jax_profiling.StepTimer(warmup=1)
    for timer in (ours, theirs):
        assert timer.summary() == {"its_per_sec": 0.0}
        for i in range(5):
            timer(i, 0.1)
    assert ours.times == theirs.times == [2.0, 0.5, 0.75, 1.25]
    assert ours.summary() == theirs.summary()
    assert ours.summary() == {"its_per_sec": 3 / 2.5, "mean_s": 2.5 / 3, "min_s": 0.5,
                              "max_s": 1.25, "n": 3}


def test_trace_if_writes_a_trace(tmp_path):
    with profiling.trace_if(str(tmp_path / "off"), enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with profiling.trace_if(str(tmp_path / "on")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "on" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_flush_runs_on_the_cpu():
    flush()


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizer")
    testing.write_tokenizer(d)
    return d


def test_native_bpe_ids_equal_the_python_loop(tokenizer_dir, monkeypatch):
    monkeypatch.delenv("LECO_TPU_NATIVE", raising=False)
    fast = CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    assert fast._native is not None, "the engine did not build or load"
    monkeypatch.setenv("LECO_TPU_NATIVE", "0")
    slow = CLIPTokenizer.from_pretrained(str(tokenizer_dir))
    assert slow._native is None
    np.testing.assert_array_equal(fast(PROMPTS), slow(PROMPTS))
    for prompt in PROMPTS:
        assert fast.tokenize(prompt) == slow.tokenize(prompt)
    assert len(fast.tokenize("van gogh")) == 2  # one merged token a word


def test_a_failed_build_is_reported(tmp_path, monkeypatch, capsys):
    broken = tmp_path / "bpe.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    native.load_bpe_library.cache_clear()
    try:
        assert native.load_bpe_library() is None
    finally:
        native.load_bpe_library.cache_clear()
    err = capsys.readouterr().err
    assert "native BPE engine unavailable" in err and "error" in err


def test_notebook_writes_yaml_the_port_reads(tmp_path, monkeypatch):
    """examples/train_torch.ipynb's form and templating cells, run as they
    are: the config and prompts they write are what `train_lora` reads."""
    from pathlib import Path

    from leco_tpu_torch.config import load_config_from_yaml
    from leco_tpu_torch.prompts import load_prompts_from_yaml

    nb = json.loads((Path(__file__).resolve().parents[1] / "examples" / "train_torch.ipynb")
                    .read_text())
    code = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
    assert "leco_tpu_torch.train_lora" in code[2] and "ab_compare" in code[3]
    monkeypatch.chdir(tmp_path)
    namespace: dict = {}
    for cell in code[:2]:
        exec(cell, namespace)
    config = load_config_from_yaml("run/config.yaml")
    assert config.train.lr == 1e-4 and config.network.rank == 4
    assert config.pretrained_model.name_or_path == "/models/stable-diffusion-v1-5"
    assert config.other.use_flash_attention is True
    (prompt,) = load_prompts_from_yaml("run/prompts.yaml")
    assert (prompt.target, prompt.resolution, prompt.unconditional) == ("van gogh", 512, "")
