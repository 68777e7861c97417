"""The port's full-state checkpoint (`leco_tpu_torch/train/checkpoint.py`)
and what `train()` does with it: resume, EMA, asynchronous saves.

The snapshot functions are held to the cases of `tests/test_checkpoint.py`
(the JAX package's); the loop runs on the tiny CPU bundle, where a run
interrupted and resumed must give the uninterrupted run's losses and
weights bit for bit."""

import json

import numpy as np
import pytest
import torch

from leco_tpu_torch.config import RootConfig
from leco_tpu_torch.lora import read_safetensors
from leco_tpu_torch.prompts import PromptSettings
from leco_tpu_torch.testing import make_random_bundle
from leco_tpu_torch.train import checkpoint as ckpt
from leco_tpu_torch.train import trainer

PROMPT = PromptSettings.from_dict({"target": "van gogh", "resolution": 64})


def _save(directory, iteration, ema=None, rng_seed=0):
    opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1)
    return ckpt.save_train_state(
        directory, lora={"w": torch.full((2,), float(iteration))}, optimizer=opt.state_dict(),
        iteration=iteration, generator_state=torch.Generator().manual_seed(3).get_state(),
        rng=np.random.default_rng(rng_seed), ema=ema)


def test_save_restore_and_latest_step(tmp_path):
    assert ckpt.latest_step(tmp_path / "none") is None
    assert ckpt.restore_train_state(tmp_path) is None
    rng = np.random.default_rng(0)
    rng.integers(0, 10, size=5)  # move the stream
    path = ckpt.save_train_state(
        tmp_path, lora={"a.lora_down": torch.arange(6.0).reshape(2, 3)},
        optimizer={"state": {}, "param_groups": []}, iteration=7,
        generator_state=torch.Generator().manual_seed(9).get_state(), rng=rng,
        ema={"a.lora_down": torch.ones(2, 3)})
    _save(tmp_path, 3)
    assert ckpt.latest_step(tmp_path) == 7
    assert path.endswith("step_7")
    assert json.loads((tmp_path / "step_7.rng.json").read_text())["has_ema"] is True
    state = ckpt.restore_train_state(tmp_path)
    assert state["iteration"] == 7
    assert torch.equal(state["lora"]["a.lora_down"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(state["ema"]["a.lora_down"], torch.ones(2, 3))
    gen = torch.Generator()
    gen.set_state(state["generator"])
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=torch.Generator().manual_seed(9)))
    assert state["rng"].integers(0, 2**31) == rng.integers(0, 2**31)
    older = ckpt.restore_train_state(tmp_path, iteration=3)
    assert older["iteration"] == 3 and "ema" not in older


def test_gc_keeps_newest_n(tmp_path):
    for s in (10, 20, 30, 40, 50):
        (tmp_path / f"step_{s}").mkdir()
        (tmp_path / f"step_{s}.rng.json").write_text("{}")
    ckpt.gc_snapshots(tmp_path, keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_40", "step_40.rng.json", "step_50", "step_50.rng.json"]
    assert ckpt.latest_step(tmp_path) == 50


def test_gc_protect_survives_reset_counter(tmp_path, monkeypatch):
    monkeypatch.setenv("LECO_KEEP_SNAPSHOTS", "2")
    for s in (100, 200, 300):
        (tmp_path / f"step_{s}").mkdir()
        (tmp_path / f"step_{s}.rng.json").write_text("{}")
    _save(tmp_path, 5)
    left = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert left == ["step_200", "step_300", "step_5"]


def test_gc_disabled_by_zero(tmp_path, monkeypatch):
    for s in (1, 2):
        (tmp_path / f"step_{s}").mkdir()
    ckpt.gc_snapshots(tmp_path, keep_last=0)
    assert len(list(tmp_path.iterdir())) == 2
    monkeypatch.setenv("LECO_KEEP_SNAPSHOTS", "0")
    for it in (3, 4, 5, 6):
        _save(tmp_path, it)
    assert len([p for p in tmp_path.iterdir() if p.is_dir()]) == 6


@pytest.mark.parametrize("keep,want", [(None, ["step_2", "step_3", "step_4"]),
                                       ("2", ["step_3", "step_4"])])
def test_save_applies_gc(tmp_path, monkeypatch, keep, want):
    """The default keeps 3; LECO_KEEP_SNAPSHOTS overrides."""
    if keep is None:
        monkeypatch.delenv("LECO_KEEP_SNAPSHOTS", raising=False)
    else:
        monkeypatch.setenv("LECO_KEEP_SNAPSHOTS", keep)
    for it in (1, 2, 3, 4):
        _save(tmp_path, it)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == want
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.endswith(".json")) == [
        f"{s}.rng.json" for s in want]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _config(tmp_path, **train):
    return RootConfig.from_dict({
        "prompts_file": "unused.yaml",
        "pretrained_model": {"name_or_path": "random://tiny"},
        "train": {"iterations": 4, "max_denoising_steps": 3, "lr": 1e-3, "seed": 0,
                  "precision": "float32", "optimizer": "lion", "lr_scheduler": "cosine",
                  "noise_scheduler": "ddpm", "save_state": True, **train},
        "save": {"name": "tiny", "path": str(tmp_path), "per_steps": 1,
                 "precision": "float32"},
    })


def _train(config, on_step=None):
    return trainer.train(config, [PROMPT], make_random_bundle(attn_backend="flash"),
                         on_step=on_step)


class Stop(Exception):
    pass


def _stop_at(j):
    def hook(i, loss):
        if i == j:
            raise Stop

    return hook


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_resume_replays_the_uninterrupted_run(tmp_path, ema_decay):
    """4 iterations against 2 + resume 2 (ddpm draws noise every step, so
    the torch generator's state is part of what must come back)."""
    whole = _train(_config(tmp_path / "whole", ema_decay=ema_decay))
    with pytest.raises(Stop):  # dies in iteration 2, before its snapshot
        _train(_config(tmp_path / "cut", ema_decay=ema_decay), on_step=_stop_at(2))
    assert ckpt.latest_step(tmp_path / "cut" / "state") == 1
    resumed = _train(_config(tmp_path / "cut", ema_decay=ema_decay, resume=True))
    assert resumed["losses"] == whole["losses"][2:]
    for k, v in whole["lora"].items():
        assert torch.equal(resumed["lora"][k], v), k
    if ema_decay:
        for k, v in whole["ema"].items():
            assert torch.equal(resumed["ema"][k], v), k
    records = [json.loads(ln) for ln in (tmp_path / "cut" / "metrics.jsonl").read_text()
               .splitlines()]
    want = [json.loads(ln) for ln in (tmp_path / "whole" / "metrics.jsonl").read_text()
            .splitlines()]
    # iterations 0-2 of the cut run (2 was logged before the hook raised),
    # then the resumed 2 and 3
    assert records == want[:3] + want[2:]
    last, _ = read_safetensors(tmp_path / "cut" / "tiny_last.safetensors")
    last_whole, _ = read_safetensors(tmp_path / "whole" / "tiny_last.safetensors")
    assert all(torch.equal(last[k], last_whole[k]) for k in last_whole)


def test_snapshot_without_ema_restarts_the_ema(tmp_path):
    with pytest.raises(Stop):
        _train(_config(tmp_path), on_step=_stop_at(2))
    restored = ckpt.restore_train_state(tmp_path / "state")
    assert "ema" not in restored
    ema = {k: v.clone() for k, v in restored["lora"].items()}
    bundle = make_random_bundle(attn_backend="flash")

    def follow(i, loss):  # the weights after iteration i
        for k, p in bundle.lora_params.items():
            ema[k] = ema[k] * 0.9 + p.detach() * (1.0 - 0.9)

    result = trainer.train(_config(tmp_path, ema_decay=0.9, resume=True), [PROMPT], bundle,
                           on_step=follow)
    assert len(result["losses"]) == 2
    for k, v in ema.items():
        assert torch.equal(result["ema"][k], v), k
    assert (tmp_path / "tiny_last_ema.safetensors").exists()
    assert (tmp_path / "tiny_2steps_ema.safetensors").exists()


@pytest.mark.parametrize("ema_decay", [1.0, 1.5, -0.5])
def test_ema_decay_outside_zero_one_raises(tmp_path, ema_decay):
    with pytest.raises(ValueError, match="ema_decay"):
        _train(_config(tmp_path, ema_decay=ema_decay))


def test_async_saves_equal_inline_saves(tmp_path):
    files = ("tiny_1steps.safetensors", "tiny_2steps.safetensors", "tiny_last.safetensors",
             "tiny_1steps_ema.safetensors", "tiny_last_ema.safetensors")
    for mode in ("inline", "async"):
        config = _config(tmp_path / mode, ema_decay=0.5, save_state=False)
        config.save.async_write = mode == "async"
        config.save.precision = "bfloat16"
        result = _train(config)
        assert [p.name for p in result["saved"]] == [
            "tiny_1steps.safetensors", "tiny_1steps_ema.safetensors",
            "tiny_2steps.safetensors", "tiny_2steps_ema.safetensors",
            "tiny_last.safetensors", "tiny_last_ema.safetensors"]
    for name in files:
        a, _ = read_safetensors(tmp_path / "inline" / name)
        b, _ = read_safetensors(tmp_path / "async" / name)
        assert set(a) == set(b) and len(a) > 0
        for k in a:
            assert a[k].dtype == torch.bfloat16 or k.endswith(".alpha")
            assert torch.equal(a[k], b[k]), (name, k)


def test_failed_writer_leaves_a_rescue_save_and_raises(tmp_path, monkeypatch):
    real = trainer.save_lora_weights

    def failing(p, *args, **kwargs):
        if "steps" in str(p):
            raise OSError("disk full")
        return real(p, *args, **kwargs)

    monkeypatch.setattr(trainer, "save_lora_weights", failing)
    config = _config(tmp_path, save_state=False)
    with pytest.raises(OSError, match="disk full"):
        _train(config)
    assert (tmp_path / "tiny_rescue.safetensors").exists()
    assert not (tmp_path / "tiny_last.safetensors").exists()
    rescued, _ = read_safetensors(tmp_path / "tiny_rescue.safetensors")
    assert len(rescued) > 0
