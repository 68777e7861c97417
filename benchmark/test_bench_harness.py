"""CPU tests of the benchmark's harness, at a tiny UNet; the tests marked
`cuda` need a card and skip without one.

    python -m pytest benchmark/ -q            # here, on the CPU
    python -m pytest benchmark/ -q -m cuda    # on the card
"""

from __future__ import annotations

import collections
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import draws
import faults
import flops
import harness
import roofline
import tracing
from compare import judge
from reference import unet as ref_unet

HERE = Path(__file__).resolve().parent
RUNNER = harness.load_module(HERE / "runners" / "lora_train.py")

TINY = {"name": "tiny", "prediction_type": "epsilon", "unet": {
    "block_out_channels": [32, 64], "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
    "cross_attention_dim": 32, "attention_head_dim": 2, "norm_num_groups": 8}}
TINY_XL = {"name": "tiny_xl", "prediction_type": "epsilon", "unet": {
    "block_out_channels": [16, 32, 64],
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 2, "transformer_layers_per_block": [1, 2, 2],
    "cross_attention_dim": 32, "attention_head_dim": [1, 2, 4], "use_linear_projection": True,
    "norm_num_groups": 8, "addition_embed_type": "text_time", "addition_time_embed_dim": 4,
    "projection_class_embeddings_input_dim": 32}}
# the card's flash kernels take head dims 40, 64, 80 and 160: the tiny UNets
# of the card test have 40-wide heads
TINY_CARD = {"name": "tiny_card", "prediction_type": "epsilon",
             "unet": dict(TINY["unet"], block_out_channels=[80, 160])}
TINY_XL_CARD = {"name": "tiny_xl_card", "prediction_type": "epsilon",
                "unet": dict(TINY_XL["unet"], block_out_channels=[40, 80, 160])}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_cell(config=TINY, precision="float32", seed=7, batch=2, high=10,
              workload="sd15-erase-b2") -> harness.Cell:
    """A cell of `workload`'s traffic and limits on a tiny UNet at 128 px,
    t_to drawn from [1, high)."""
    traffic = json.loads((HERE / "traffic" / "erase-512-b2.json").read_text())
    traffic.update(resolution=128, batch_size=batch, precision=precision)
    traffic["t_to"] = dict(traffic["t_to"], high=high)
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]
    return harness.Cell(workload, 1, copy.deepcopy(config), traffic, limits, seed, 0, False,
                        time.time())


# ---- the draws


def test_antithetic_pairs_are_uniform_and_sum_to_fifty():
    pairs = draws.TimestepPairs(2**31 + 12345, 1, 50)
    drawn = [pairs.next_pair() for _ in range(4900)]
    assert all(a + b == 50 for a, b in drawn)
    for column in zip(*drawn):
        counts = collections.Counter(column)
        assert set(counts) == set(range(1, 50))
        assert all(50 <= c <= 150 for c in counts.values())  # 100 expected each
    assert sum(a + b for a, b in drawn[:7]) / 14 == 25


def test_draws_repeat_for_a_seed_and_differ_across_seeds():
    sizes = ref_unet.UNetSizes.from_config(TINY["unet"])
    shapes, lora_shapes = ref_unet.shapes(sizes, 4)
    a = draws.unet_weights(shapes, 5, "cpu", torch.bfloat16)
    b = draws.unet_weights(shapes, 5, "cpu", torch.bfloat16)
    c = draws.unet_weights(shapes, 6, "cpu", torch.bfloat16)
    assert set(a) == set(shapes)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert a["conv_norm_out.weight"].dtype == torch.float32
    assert a["conv_in.weight"].dtype == torch.bfloat16
    lora = draws.lora_init(lora_shapes, 5, "cpu")
    assert set(lora) == set(lora_shapes)
    for k, v in lora.items():  # kaiming-uniform, lora_up too: never all zero
        bound = 1 / math.sqrt(math.prod(lora_shapes[k][1:]))
        assert v.abs().max() <= bound and v.abs().max() > 0.9 * bound, k
    assert not torch.equal(lora[k], draws.lora_init(lora_shapes, 6, "cpu")[k])


# ---- the FLOP count


def _count_by_shapes(sizes, res: int, batch: int) -> int:
    """One forward's products counted from the layers' shapes (hooks on the
    reference's Linear and Conv2d, the attention cores by their calls)."""
    with torch.device("meta"):
        unet = ref_unet.UNet(sizes)
    total = 0

    def linear(mod, args, out):
        nonlocal total
        total += 2 * args[0].numel() // args[0].shape[-1] * mod.in_features * mod.out_features

    def conv(mod, args, out):
        nonlocal total
        total += 2 * out.numel() * mod.in_ch * mod.kernel * mod.kernel

    for m in unet.modules():
        if isinstance(m, ref_unet.Linear):
            m.register_forward_hook(linear)
        elif isinstance(m, ref_unet.Conv2d):
            m.register_forward_hook(conv)
    unet.run.mode = "off"
    with torch.no_grad():
        unet(*flops._inputs(sizes, res, batch))
    for bh, nq, nk, d in flops.attention_calls(sizes, res, batch):
        total += 4 * bh * nq * nk * d
    return total


@pytest.mark.parametrize("config", [TINY, TINY_XL], ids=["sd", "xl"])
def test_flop_count_matches_layer_shapes(config):
    sizes = ref_unet.UNetSizes.from_config(config["unet"])
    parts = flops.step_parts(sizes, 128, 2, 4, 1.0)
    assert parts["forward"] == _count_by_shapes(sizes, 128, 2)
    assert parts["target_forward"] > parts["forward"]  # the LoRA branch on
    assert parts["forward"] < parts["target_backward"] < 2 * parts["target_forward"]
    # linear in the batch, and t_to forwards at 2B
    assert flops.step_parts(sizes, 128, 4, 4, 1.0)["forward"] == 2 * parts["forward"]
    assert (flops.step_flops(sizes, 128, 2, 4, 1.0, 10)
            - flops.step_flops(sizes, 128, 2, 4, 1.0, 9)) == 2 * parts["forward"]


def test_attention_core_roofline_counts_q_k_v_o_once():
    ops, nbytes = roofline.attention_core_work(16, 4096, 4096, 40)
    assert ops == 4 * 16 * 4096 * 4096 * 40
    assert nbytes == 16 * 40 * 2 * (2 * 4096 + 2 * 4096)
    assert roofline.bound_ms(ops, nbytes) == pytest.approx(ops / 989e12 * 1e3)


# ---- the metric readers on a synthetic profile


class FakeEvent:
    def __init__(self, name, device, start, dur, corr=0, link=0, annotation=False):
        self._v = (name, device, start, dur, corr, link, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def synthetic_record() -> dict:
    """Two iterations' worth of events: a flash forward inside attn1's core
    scope (its projection outside the core), an elementwise kernel, a
    layout conversion and a copy outside the UNet; 10 us of wall time."""
    cpu = [FakeEvent("bench/attn1(self)/core", "cpu", 0, 3000, 1, annotation=True),
           FakeEvent("bench/attn1(self)/to_q", "cpu", 100, 400, 2, annotation=True),
           FakeEvent("aten::mm", "cpu", 150, 300, 3),
           FakeEvent("cudaLaunchKernel", "cpu", 200, 10, 100, 3),
           FakeEvent("aten::bmm", "cpu", 600, 300, 4),
           FakeEvent("cuLaunchKernelEx", "cpu", 700, 10, 101, 4),
           FakeEvent("aten::mul", "cpu", 4000, 100, 5),
           FakeEvent("cudaLaunchKernel", "cpu", 4050, 10, 102, 5),
           FakeEvent("aten::copy_", "cpu", 5000, 100, 6),
           FakeEvent("cudaLaunchKernel", "cpu", 5050, 10, 103, 6),
           FakeEvent("cudaLaunchKernel", "cpu", 5060, 10, 104, 6)]
    device = [FakeEvent("ampere_bf16_gemm", "cuda", 300, 500, 100, 3),
              FakeEvent("flash_fwd_kernel", "cuda", 1000, 1000, 101, 4),
              FakeEvent("vectorized_elementwise_kernel", "cuda", 5000, 1000, 102, 5),
              FakeEvent("nchwToNhwcKernel", "cuda", 6000, 500, 103, 6),
              FakeEvent("Memcpy DtoH", "cuda", 7000, 500, 104, 6)]
    traced = tracing.analyze({"device": device, "cpu": cpu, "wall_s": 10e-6}, 2)
    traced["core_bound_ms"] = 0.25e-3
    return {"trace": traced, "attempted": 10, "window_s": 4.0, "window_flops": 989e12,
            "peak_flops": 989e12, "peak_bytes": 3 * 2**30, "setup_s": 12.5}


@pytest.mark.parametrize("metric,value", [
    ("train.launches_per_it", 2.5),
    ("train.elementwise_ms_per_it", 0.5e-3),
    ("train.layout_ms_per_it", 0.5e-3),
    ("train.attn_core_roofline", 25.0),
    ("train.device_idle_share", 100 * (1 - 3.5e-6 / (4.0 * 2 / 10))),
    ("train.step_mfu", 25.0),
    ("train_it_per_s", 2.5),
    ("peak_mem_gib", 3.0),
    ("setup_s", 12.5),
])
def test_metric_readers_on_a_synthetic_profile(metric, value):
    record = synthetic_record()
    assert harness.load_module(HERE / "metrics" / f"{metric}.py").read(record) == \
        pytest.approx(value)


def test_trace_attributes_kernels_by_launch_and_names_gaps():
    t = synthetic_record()["trace"]
    assert t["by_component_ms"]["attn1(self)/core"] == pytest.approx(1e-3)
    assert t["by_component_ms"]["attn1(self)/to_q"] == pytest.approx(0.5e-3)
    assert t["busy_s"] == pytest.approx(3.5e-6)
    assert t["idle_gaps"][0][1] == pytest.approx(3e-6)
    assert "aten::mul" in t["idle_gaps"][0][0]


def test_per_layer_readers_leave_untraced_runs_out():
    for m in harness.manifest()["per_layer"]:
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert reader.read({"attempted": 2, "window_s": 1.0, "peak_bytes": 0}) is None


# ---- the manifest


def test_manifest_meets_the_contract():
    bench = harness.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()


# ---- the comparison: the reference against the program, and its faults


@pytest.mark.parametrize("config", [TINY, TINY_XL], ids=["sd", "xl"])
def test_reference_follows_the_program_in_float32(config):
    record = RUNNER.run_on(tiny_cell(config), "cpu")
    values = record["reference"]["readings"]
    assert record["correct"] and record["failed"] == 0 and record["attempted"] >= 2
    assert all(v < 1e-4 for v in values.values()), values


def test_sound_bf16_run_is_correct():
    record = RUNNER.run_on(tiny_cell(precision="bfloat16"), "cpu")
    assert record["correct"], record["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "lora_on_reference", "unchanged_state"])
def test_a_broken_timed_path_is_not_correct(fault):
    try:
        record = RUNNER.run_on(tiny_cell(precision="bfloat16"), "cpu",
                               fault=faults.FAULTS[fault])
    finally:
        faults.restore()
    assert not record["correct"], record["checks"]


@pytest.mark.parametrize("config", [TINY, TINY_XL], ids=["sd", "xl"])
def test_the_comparison_sees_an_inner_denoise_without_the_fold(config):
    # the tiny UNets' LoRA moves their output too little for the full-size
    # limits to see a skipped fold in bf16 (on the card every seed fails
    # them); in float32, where a sound run reads under 1e-4, it reads 100x that
    try:
        record = RUNNER.run_on(tiny_cell(config), "cpu", fault=faults.FAULTS["fold_skipped"])
    finally:
        faults.restore()
    values = record["reference"]["readings"]
    assert max(values[k] for k in ("loss_gap", "grad_gap")) > 1e-2, values
    assert max(values[k] for k in ("late.loss_gap", "late.grad_gap")) > 1e-2, values


def test_the_median_leaf_change_sees_every_leaf_and_not_one():
    from compare import readings
    from reference.train import Followed

    initial = {f"leaf{i}": torch.zeros(4) for i in range(9)}
    grads = [{k: 1.0 for k in initial}]
    ref = Followed([1.0], {k: torch.ones(4) for k in initial}, grads,
                   {k: torch.ones(4) for k in initial})
    one_off = Followed([1.0], ref.first_grad, grads, dict(ref.params, leaf3=torch.ones(4) * 1.5))
    every = Followed([1.0], ref.first_grad, grads, {k: torch.ones(4) * 1.2 for k in initial})
    values = readings(one_off, ref, initial)[0]
    assert values["change_gap"] == pytest.approx(0.5) and values["change_median_gap"] == 0.0
    values = readings(every, ref, initial)[0]
    assert values["change_median_gap"] == pytest.approx(0.2)


def test_the_control_fails_the_limits():
    # the whole t_to range: the float8 control's error grows with the denoise
    cell = tiny_cell(precision="bfloat16", high=50)
    control = RUNNER.control(cell, "cpu")
    ok, checks = judge(control["readings"], cell.limits)
    assert not ok, checks


@pytest.mark.cuda
def test_the_control_fails_the_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for workload in ("sd15-erase-b2", "sdxl-erase-1024"):
        cell = tiny_cell(TINY_XL_CARD if "xl" in workload else TINY_CARD,
                         precision="bfloat16", workload=workload, high=50)
        ok, checks = judge(RUNNER.control(cell, "cuda")["readings"], cell.limits)
        assert not ok, (workload, checks)
        record = RUNNER.run_on(cell, "cuda")
        assert record["correct"], (workload, record["checks"])


# ---- what the run imports


def test_the_harness_and_reference_load_no_jax():
    code = """
import sys
sys.path[:0] = [{here!r}, {root!r}]
import run, harness, compare, draws, faults, flops, readings, roofline, tracing
from reference import unet, train, precision
assert not any(m.split('.')[0] == 'leco_tpu_torch' for m in sys.modules), 'reference'
rt = harness.load_module(harness.HERE / 'runners' / 'lora_train.py')
import leco_tpu_torch.train.trainer, leco_tpu_torch.train.optim, leco_tpu_torch.testing
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'leco_tpu'}}))
""".format(here=str(HERE), root=str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_match_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "leco_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake.sub", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_run_without_a_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "sd15-erase-b2",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=HERE.parent)
    assert out.returncode != 0 and out.stdout == ""


def test_result_line_puts_the_checks_last():
    record = {"correct": True, "attempted": 4, "failed": 0, "device": {"platform": "gpu"},
              "checks": {"loss_gap": {"value": math.inf, "limit": 0.1}}}
    line = harness.result_line(record, {"train_it_per_s": {"value": 1.0, "unit": "it/s"}})
    assert list(line)[-1] == "checks" and line["checks"]["loss_gap"]["value"] == "inf"
    json.dumps(line, allow_nan=False)
