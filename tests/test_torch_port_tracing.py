"""The recorder of spans and counters (`leco_tpu_torch/utils/profiling.py`)
and the train step's phases, on the CPU at the tiny UNet: off, it records
nothing and hands back one shared no-op; on, one step's spans come once
each, in order, under `leco.step`, the inner denoise counts its UNet
calls, the step computes what it computes off, bit for bit, and train()'s
set-up stages are points on the recorder's clock; under
torch.profiler each span is a `record_function` range on the recorder's
own clock; `trace_if` turns the recorder on inside its block."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from leco_tpu_torch.config import RootConfig
from leco_tpu_torch.prompts import PromptSettings
from leco_tpu_torch.testing import make_random_bundle
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer
from leco_tpu_torch.utils import profiling

RES, T_TO, MAX_STEPS = 64, 3, 50
PHASES = ["leco.step", "leco.fold", "leco.inner_denoise", "leco.reference_forward",
          "leco.target_forward", "leco.loss", "leco.backward", "leco.optimizer"]


@pytest.fixture(autouse=True)
def quiet_recorder():
    """Each test starts and ends with the recorder off and empty, one
    torch thread (the tiny UNet's arithmetic is bitwise repeatable)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enable(False)
    profiling.take()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.take()
        torch.set_num_threads(threads)


def one_step(seed: int = 0):
    """A fresh tiny bundle's train step -> (loss, the LoRA after it)."""
    bundle = make_random_bundle(seed=seed)
    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": RES})
    pair = trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0]
    pack = trainer.build_pack(pair, False, RES, RES)
    params = bundle.lora_params
    step = trainer.make_train_step(
        bundle, get_optimizer("adamw", list(params.values()), 1e-4), MAX_STEPS)
    loss = step(pack, 1.0, 1.0, T_TO, height=RES, width=RES,
                generator=torch.Generator().manual_seed(seed))
    return loss, {k: p.detach().clone() for k, p in params.items()}


def test_off_records_nothing_and_spans_are_one_shared_no_op():
    assert not profiling.RECORDER.on
    first, second = profiling.span("leco.a"), profiling.span("leco.b")
    assert first is second
    with first as inside:
        assert inside is None
    profiling.count("unet.inner_calls", 3)
    one_step()
    assert profiling.take() == {"spans": [], "counters": {}}


def test_on_and_off_give_a_bitwise_equal_step():
    loss_off, lora_off = one_step()
    with profiling.recording():
        loss_on, lora_on = one_step()
    assert profiling.take()["spans"]
    assert torch.equal(loss_on, loss_off)
    assert lora_on.keys() == lora_off.keys()
    assert all(torch.equal(lora_on[k], lora_off[k]) for k in lora_on)


def test_step_spans_come_once_each_in_order_under_the_step():
    with profiling.recording() as recorder:
        assert recorder.on
        one_step()
    assert not profiling.RECORDER.on
    taken = profiling.take()
    spans = taken["spans"]
    assert [s["name"] for s in spans] == PHASES
    assert spans[0]["parent"] is None
    assert all(s["parent"] == 0 for s in spans[1:])
    for s in spans:
        assert spans[0]["start_ns"] <= s["start_ns"] <= s["end_ns"] <= spans[0]["end_ns"]
    for a, b in zip(spans[1:], spans[2:]):
        assert a["end_ns"] <= b["start_ns"]
    assert taken["counters"] == {"unet.inner_calls": T_TO}
    assert profiling.take() == {"spans": [], "counters": {}}


def test_nested_spans_name_their_parent_and_take_refuses_an_open_span():
    with profiling.recording():
        with profiling.span("leco.outer"):
            with profiling.span("leco.inner"):
                with pytest.raises(RuntimeError, match="leco.inner"):
                    profiling.take()
        with profiling.span("leco.after"):
            pass
    spans = profiling.take()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("leco.outer", None), ("leco.inner", 0), ("leco.after", None)]


def test_spans_are_record_function_ranges_on_the_recorders_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording():
        one_step()
    spans = profiling.take()["spans"]
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("leco.")), key=lambda e: e.start_ns())
    assert [e.name() for e in ranges] == PHASES == [s["name"] for s in spans]
    for e, s in zip(ranges, spans):
        assert e.is_user_annotation()
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000, (s["name"], "start")
        assert abs(e.start_ns() + e.duration_ns() - s["end_ns"]) < 1_000_000, (s["name"], "end")


def test_trace_if_turns_the_recorder_on_inside_its_block(tmp_path):
    with profiling.trace_if(str(tmp_path)):
        assert profiling.RECORDER.on
        one_step()
    assert not profiling.RECORDER.on
    assert [s["name"] for s in profiling.take()["spans"]] == PHASES
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("name", "").startswith("leco.")]
    assert sorted(set(names)) == sorted(PHASES)
    with profiling.trace_if(str(tmp_path / "off"), enabled=False):
        assert not profiling.RECORDER.on


def test_train_records_its_stages_as_points(tmp_path, monkeypatch, capsys):
    """With the recorder on, train()'s eight set-up stages are point spans
    on its clock, among the step's, whether or not LECO_TRAIN_STAGES
    prints them."""
    monkeypatch.delenv("LECO_TRAIN_STAGES", raising=False)
    config = RootConfig.from_dict({
        "prompts_file": "unused.yaml",
        "pretrained_model": {"name_or_path": "random://tiny"},
        "train": {"iterations": 1, "max_denoising_steps": 3, "lr": 1e-4, "seed": 0,
                  "precision": "float32"},
        "save": {"name": "tiny", "path": str(tmp_path), "per_steps": 0},
    })
    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": RES})
    with profiling.recording():
        trainer.train(config, [settings], make_random_bundle(seed=0))
    assert not [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train")]
    spans = profiling.take()["spans"]
    stages = [s for s in spans if s["name"].startswith("leco.stage: ")]
    assert len(stages) == 8 and all(s["parent"] is None for s in stages)
    assert [s["start_ns"] for s in stages] == sorted(s["start_ns"] for s in stages)
    assert all(s["end_ns"] - s["start_ns"] < 10_000_000 for s in stages)
    step = next(s for s in spans if s["name"] == "leco.step")
    assert stages[-3]["end_ns"] <= step["start_ns"] <= step["end_ns"] <= stages[-2]["start_ns"]
    assert stages[-2]["name"] == "leco.stage: loop: first step returned (kernels queued)"
