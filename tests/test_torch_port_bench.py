"""The port's measurement entry points (`leco_tpu_torch/bench.py`,
`scripts/{bench_full,bench_xl,profile_step,profile_unet}.py`,
`utils/benchkit.py`) against the JAX repository's `bench.py`,
`scripts/bench_full.py`, `scripts/bench_xl.py`, `scripts/profile_unet.py`
and `scripts/attribute_fwd.py`, on the CPU at tiny sizes: the seeded
timesteps_to sample, the FLOP counts, the records' fields and metric
strings, the losses of the timed steps, the profiler's breakdown on a
synthetic event list, and the refusal to run on a missing GPU."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from leco_tpu_torch import bench
from leco_tpu_torch.lora import LoRAConv2d, LoRALinear, LoRASpec
from leco_tpu_torch.models.unet import GEGLU, Attention, sd15_config, tiny_unet_config
from leco_tpu_torch.prompts import PromptSettings
from leco_tpu_torch.scripts import bench_full, bench_xl, profile_step, profile_unet
from leco_tpu_torch.testing import make_random_bundle, tiny_xl_unet_config
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer
from leco_tpu_torch.utils import benchkit

REPO = Path(__file__).resolve().parents[1]
SD15_512_COUNTED_FORWARD = 768_998_113_280  # one SD1.5 forward at 512 px, batch 1


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny UNet's calls are a few microseconds of arithmetic each:
    more threads only add synchronisation (and contend with the other test
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def load_by_path(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_metric(script: str, **fields) -> str:
    """The metric f-string of a JAX bench script, formatted with `fields`."""
    text = (REPO / script).read_text()
    return re.search(r'"metric": f"([^"]+)"', text).group(1).format(**fields)


def history_digest() -> tuple:
    """The JAX history's bytes, and whether a port history file exists."""
    jax_history = hashlib.sha256((REPO / "bench_history.jsonl").read_bytes()).hexdigest()
    return jax_history, (REPO / "bench_history_torch.jsonl").exists()


# ---------------------------------------------------------------------------
# benchkit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [12, 3, 6, 2])
def test_timesteps_to_sample_is_the_jax_benches(n):
    """bench.py:174-175 (12 on the chip, 3 on the CPU) and
    scripts/bench_xl.py:108-109 (6 and 2)."""
    want = np.random.default_rng(0).integers(1, 50, size=n)
    assert benchkit.timesteps_to_sample(n) == [int(t) for t in want]


def test_device_record_reads_nvidia_smi_or_says_it_failed(monkeypatch):
    def smi(cmd, **kw):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(benchkit.subprocess, "run", smi)
    assert benchkit.device_record() == {"nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
                                        "name": "NVIDIA H100 80GB HBM3",
                                        "power_limit": "700.00 W"}

    def missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(benchkit.subprocess, "run", missing)
    record = benchkit.device_record()
    assert record["nvidia_smi"] is None and "FileNotFoundError" in record["error"]
    assert "name" not in record and "power_limit" not in record


def test_knobs_and_history_append(monkeypatch, tmp_path, capsys):
    """The knobs of a record; and a bench run writes no history file, here
    or at the repo's root (the benchmark keeps the measurements)."""
    monkeypatch.setenv("LECO_ZZ", "1")
    monkeypatch.setenv("LECO_AA", "x")
    monkeypatch.setenv("NOT_LECO", "y")
    knobs = benchkit.knobs()
    assert list(knobs)[0] <= "LECO_AA" and knobs["LECO_ZZ"] == "1" and "NOT_LECO" not in knobs
    assert list(knobs) == sorted(knobs)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LECO_BENCH_RES", "64")
    before = history_digest()
    record = bench.main(["--device", "cpu"], bundle=make_random_bundle(seed=0))
    assert json_lines(capsys.readouterr().out) == [record]
    assert list(tmp_path.iterdir()) == []
    assert history_digest() == before == (before[0], False)
    assert not hasattr(benchkit, "append_history") and not hasattr(benchkit, "HISTORY")


# ---------------------------------------------------------------------------
# FLOP counts (profile_unet)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res,batch", [(512, 1), (768, 2), (64, 1)])
def test_unet_flops_is_the_jax_scripts(res, batch):
    jax_script = load_by_path("jax_profile_unet", REPO / "scripts" / "profile_unet.py")
    assert profile_unet.unet_flops(res, batch) == jax_script.unet_flops(res, batch)


def layer_shape_flops(config, res: int, batch: int) -> int:
    """The forward's FLOPs from its layers' shapes, by forward hooks:
    2·out·(Cin/groups·kh·kw) a conv (an upsampler's phase convolutions:
    one conv of 4·Cout 2x2 kernels over x padded by one), 2·out·in a
    linear layer (the GEGLU projection too), 4·B·Nq·Nk·C an attention
    (2·B·heads·Nq·Nk·D for the scores and as much for the values)."""
    unet = profile_unet.meta_unet(config)
    total = [0]

    def conv(mod, args, out):
        if mod.pre_upsample:
            b, cin, h, w = args[0].shape
            total[0] += 2 * b * 4 * mod.out_channels * (h + 1) * (w + 1) * cin * 4
        else:
            total[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size ** 2

    def linear(mod, args, out):
        total[0] += 2 * out.numel() * mod.in_features

    def geglu(mod, args, out):
        x = args[0]
        total[0] += 2 * (x.numel() // x.shape[-1]) * mod.proj.in_features * mod.proj.out_features

    def attention(mod, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else x
        total[0] += 4 * x.shape[0] * x.shape[1] * ctx.shape[1] * mod.to_q.out_features

    for mod in unet.modules():
        hook = {LoRAConv2d: conv, LoRALinear: linear, GEGLU: geglu,
                Attention: attention}.get(type(mod))
        if hook is not None:
            mod.register_forward_hook(hook)
    x, t, ctx, added = profile_unet.meta_inputs(config, res, batch)
    with torch.no_grad():
        unet(x, t, ctx, added)
    return total[0]


def test_counted_flops_equal_the_layer_shapes_count():
    config = tiny_unet_config()
    for res, batch in ((64, 2), (128, 1)):
        assert profile_unet.counted_unet_flops(config, res, batch) == \
            layer_shape_flops(config, res, batch)


def test_sd15_counted_forward_is_pinned():
    """The count the finding rests on: 768,998,113,280 FLOPs a forward at
    512 px, 1.173x the JAX script's estimate."""
    counted = profile_unet.counted_unet_flops(sd15_config(), 512, 1)
    assert counted == SD15_512_COUNTED_FORWARD
    assert round(counted / profile_unet.unet_flops(512, 1), 3) == 1.173


def test_step_flops_add_up_the_step():
    config, spec = tiny_unet_config(), LoRASpec(rank=4, alpha=1.0)
    fwd = profile_unet.counted_unet_flops(config, 64, 1)
    assert profile_unet.counted_unet_flops(config, 64, 3) == 3 * fwd  # linear in the batch
    target = profile_unet.counted_unet_flops(config, 64, 1, lora=spec)
    backward = profile_unet.counted_unet_flops(config, 64, 1, backward=True, lora=spec)
    step = profile_unet.step_flops(config, 64, 1, 25, spec)
    assert step["inner_forwards"] == 50 * fwd and step["reference_forward"] == 3 * fwd
    assert (step["target_forward"], step["target_backward"]) == (target, backward)
    assert step["total"] == 53 * fwd + target + backward + step["lora_fold"]
    assert 0 < step["lora_products"] < step["total"] - 53 * fwd
    assert step["lora_share"] == step["lora_products"] / step["total"]


def test_time_unet_on_the_tiny_unet():
    times = profile_unet.time_unet(make_random_bundle(), 64, 1, iters=1)
    assert times["fwd_s"] > 0 and times["fwd_bwd_s"] > 0


# ---------------------------------------------------------------------------
# the benches
# ---------------------------------------------------------------------------

BENCH_FIELDS = {
    "metric", "value", "unit", "vs_baseline", "platform", "mean_inner_steps", "attn",
    "remat", "batch", "sync", "per_iter_its_per_sec", "knobs", "time_to_first_iter_s",
    "ttfi_breakdown_s", "kernels_built_now", "device", "tflops_per_s", "mfu",
    "timesteps_to", "losses",
}


def json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_tiny_bench_prints_the_jax_line_and_the_steps_losses(monkeypatch, capsys):
    """bench.main on the tiny UNet (64 px, the CPU's 3 timed draws): one
    JSON line with the JAX record's fields and metric string, and losses
    equal to those of make_train_step driven directly with the same
    generator, optimizer and t_to sequence; no history written."""
    monkeypatch.setenv("LECO_BENCH_RES", "64")
    before = history_digest()
    record = bench.main(["--device", "cpu"], bundle=make_random_bundle(seed=0))
    lines = json_lines(capsys.readouterr().out)
    assert lines == [record]
    assert set(record) == BENCH_FIELDS
    assert record["metric"] == jax_metric("bench.py", res=64)
    assert bench.metric(512) == "LoRA train iters/sec/chip, SD1.5 512px bf16 rank4 ddim"
    assert bench.metric(512) == jax_metric("bench.py", res=512)
    assert record["timesteps_to"] == [42, 32, 26] and record["mean_inner_steps"] == 100 / 3
    assert (record["unit"], record["sync"], record["platform"]) == (
        "it/s", "deferred_fetch_all", "cpu")
    assert record["value"] > 0 and record["per_iter_its_per_sec"] > 0
    assert set(record["ttfi_breakdown_s"]) == {"build", "kernel_build", "first_exec"}
    assert record["kernels_built_now"] is False
    # device numbers are not taken on the CPU
    assert record["mfu"] is None and record["tflops_per_s"] is None and record["device"] is None
    assert record["knobs"]["LECO_BENCH_RES"] == "64"
    assert history_digest() == before

    bundle = make_random_bundle(seed=0)
    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": 64})
    pair = trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0]
    pack = trainer.build_pack(pair, False, 64, 64)
    step = trainer.make_train_step(
        bundle, get_optimizer("adamw", list(bundle.lora_params.values()), 1e-4), 50)
    generator = torch.Generator().manual_seed(0)
    losses = [step(pack, 1.0, 1.0, t, height=64, width=64, generator=generator).item()
              for t in [25, 42, 32, 26, 42, 32, 26]]
    got = record["losses"]
    assert [got["warm_up"], *got["per_iter"], *got["deferred"]] == losses


def test_tiny_bench_xl_prints_the_jax_line(monkeypatch, capsys):
    monkeypatch.setenv("LECO_BENCH_RES", "64")
    before = history_digest()
    bundle = make_random_bundle(config=tiny_xl_unet_config(depth=1), seed=0)
    record = bench_xl.main(["--device", "cpu"], bundle=bundle)
    assert json_lines(capsys.readouterr().out) == [record]
    assert record["metric"] == jax_metric("scripts/bench_xl.py", res=64)
    assert bench_xl.metric(1024) == "SDXL LoRA train iters/sec/chip, 1024px bf16 rank4 ddim"
    assert record["timesteps_to"] == [42, 32]
    losses = [record["losses"]["warm_up"], *record["losses"]["per_iter"],
              *record["losses"]["deferred"]]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert history_digest() == before


FULL_FIELDS = {
    "metric", "value", "unit", "vs_baseline", "platform", "iterations", "batch",
    "step_chunk", "train_loop_s", "device_init_s", "bundle_build_s",
    "time_to_first_fetched_loss_s", "steady_state_its_per_sec", "per_100_iter_its_per_sec",
    "kernels_built_now", "kernel_build_s", "memory_stats", "memory_stats_note",
    "losses_finite", "n_losses", "loss_first10_mean", "loss_last10_mean", "saves_written",
    "metrics_jsonl_lines", "knobs", "device",
}


def test_tiny_bench_full_record(monkeypatch, tmp_path, capsys):
    """LECO_FULL_TINY=1 LECO_FULL_ITERS=4 through the real train(): the
    JAX record's fields (the XLA counters replaced by the kernels' build),
    metrics.jsonl's lines, the final save; no history written."""
    monkeypatch.setenv("LECO_FULL_TINY", "1")
    monkeypatch.setenv("LECO_FULL_ITERS", "4")
    monkeypatch.setenv("LECO_FULL_OUT", str(tmp_path / "out"))
    before = history_digest()
    record = bench_full.main(["--device", "cpu"])
    assert json_lines(capsys.readouterr().out) == [record]
    assert set(record) == FULL_FIELDS
    assert record["metric"] == ("500-iteration van-gogh erase wall-clock, SD1.5 64px bf16 "
                                "rank4 ddim batch1 (REAL train() loop, end-to-end)")
    assert (record["iterations"], record["n_losses"], record["metrics_jsonl_lines"]) == (4, 4, 4)
    assert record["losses_finite"] and record["saves_written"] == ["van_gogh_last.safetensors"]
    assert (tmp_path / "out" / "van_gogh_last.safetensors").exists()
    assert len(record["per_100_iter_its_per_sec"]) == 1 and record["memory_stats"] == {}
    assert history_digest() == before


def test_bench_full_refuses_step_chunk(monkeypatch, tmp_path):
    monkeypatch.setenv("LECO_FULL_TINY", "1")
    monkeypatch.setenv("LECO_FULL_CHUNK", "2")
    monkeypatch.setenv("LECO_FULL_OUT", str(tmp_path / "out"))
    with pytest.raises(NotImplementedError, match="not ported: train.step_chunk . 1"):
        bench_full.main(["--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry", [bench.main, bench_xl.main, bench_full.main,
                                   profile_step.main, profile_unet.main],
                         ids=["bench", "bench_xl", "bench_full", "profile_step", "profile_unet"])
def test_entry_points_refuse_cuda_without_a_gpu(entry):
    """Every entry point defaults to --device cuda and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry([])


# ---------------------------------------------------------------------------
# profile_step
# ---------------------------------------------------------------------------


def device_event(i: int, name: str, start: float, end: float, scope: bool = False):
    return FunctionEvent(id=i, name=name, thread=0, start_us=start, end_us=end,
                         use_device="cuda", device_type=DeviceType.CUDA,
                         is_user_annotation=scope)


def test_analyze_a_synthetic_trace():
    """Busy time, idle share, categories and components of a known event
    list: two UNet scopes nested in the forward's, a GEMM inside to_q, a
    conversion in the forward but in no component, a copy and an
    elementwise kernel outside it, and annotations analyze must not count
    as kernels (a foreign one, the optimizer's) or as components."""
    events = [
        device_event(1, "flash_fwd_kernel(CUtensorMap, int)", 0, 10),
        device_event(2, "void cudnn::engines_precompiled::nchwToNhwcKernel<>", 10, 14),
        device_event(3, "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 20, 30),
        device_event(4, "Memcpy HtoD (Pageable -> Device)", 40, 41),
        device_event(5, "void at::native::vectorized_elementwise_kernel<4>", 50, 55),
        device_event(6, "leco/unet/other", 0, 31, scope=True),
        device_event(7, "leco/attn1(self)/core", 0, 10, scope=True),
        device_event(8, "leco/attn1(self)/to_q", 20, 30, scope=True),
        device_event(9, "Optimizer.step#AdamW.step", 39, 56, scope=True),
        FunctionEvent(id=10, name="aten::mm", thread=0, start_us=0, end_us=100),  # CPU
    ]
    out = profile_step.analyze(events, wall_s=100e-6)
    assert out["device_busy_s"] == pytest.approx(30e-6)
    assert out["device_idle_share"] == pytest.approx(0.7)
    assert (out["kernel_launches"], out["component_scopes"]) == (5, 3)
    assert out["top_kernels"][0][1:] == [pytest.approx(0.01), 1]
    share = {k: v[1] for k, v in out["by_category_ms_share"].items()}
    assert share == pytest.approx({
        "kernel 1/4 flash forward (3-d, packed)": 1 / 3, "NCHW<->NHWC": 4 / 30,
        "cuBLAS GEMM": 1 / 3, "copies": 1 / 30, "elementwise": 5 / 30})
    ms = {k: v[0] for k, v in out["by_component_ms_share"].items()}
    assert ms == pytest.approx({"attn1(self)/core": 0.010, "attn1(self)/to_q": 0.010,
                                "unet/other": 0.004, profile_step.OUTSIDE: 0.006})
    halved = profile_step.analyze(events, 100e-6, steps=2)
    assert halved["device_busy_s"] == pytest.approx(15e-6)


def test_component_scopes_on_the_cpu_and_no_device_time_raises():
    """The hooks open one scope a bucket's module on every forward and are
    gone after the block; a trace with no device time raises."""
    from torch.profiler import ProfilerActivity, profile

    bundle = make_random_bundle()
    x, ctx = torch.zeros(1, 4, 8, 8), torch.zeros(1, 77, 32)
    with profile_step.component_scopes(bundle.unet), profile(
            activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        bundle.unet(x, 500.0, ctx)
    names = [e.name for e in prof.events() if e.name.startswith(profile_step.SCOPE)]
    assert names.count("leco/unet/other") == 1
    assert names.count("leco/attn1(self)/core") == 4  # down 1, mid 1, up 2 transformers
    assert {"leco/attn2(cross)/to_k", "leco/transformer/ff", "leco/resnet/conv1",
            "leco/updown/sample", "leco/conv_in/out"} <= set(names)
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in bundle.unet.modules())
    with pytest.raises(RuntimeError, match="no device time"):
        profile_step.analyze(prof.events(), wall_s=1.0)


def test_components_are_the_jax_buckets():
    """Each SD1.5 module's bucket is what `attribute_fwd.component_of` gives
    its path, but for the transformer blocks' norm1/norm2, which that
    substring match files under resnet/norm."""
    attribute_fwd = load_by_path("jax_attribute_fwd", REPO / "scripts" / "attribute_fwd.py")
    with torch.device("meta"):
        unet = profile_unet.meta_unet(sd15_config())
    seen = set()
    for name, _ in unet.named_modules():
        bucket = profile_step.component_of(name) if name else None
        if bucket is None:
            continue
        seen.add(bucket)
        path = "/" + re.sub(r"\.(\d+)", r"_\1", name).replace(".", "/") + "/"
        want = attribute_fwd.component_of(path)
        if bucket == "transformer/ln" and name.rsplit(".", 1)[-1] in ("norm1", "norm2"):
            want = {"resnet/norm": "transformer/ln"}[want]
        assert bucket == want, (name, path)
    assert len(seen) == 22  # SD1.5 has no add_embedding
