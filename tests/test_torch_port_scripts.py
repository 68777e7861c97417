"""The port's last measurement scripts (`leco_tpu_torch/scripts/{profile_fwd,
bench_convs,bench_pallas_conv,ab_convfold}.py` and the chained-carry timer
`utils/benchkit.chained_times`) against the JAX repository's
`scripts/{profile_fwd,bench_convs,bench_pallas_conv,ab_convfold}.py`, on
the CPU at tiny sizes: each carry against the JAX script's own function on
the same numpy inputs, the case lists, the profiled forward against the
JAX package's UNet on the same weights, `analyze` on a synthetic event
list, the CPU records, and the refusal to run on a missing GPU."""

from __future__ import annotations

import ast
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from leco_tpu import lora as jax_lora
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu_torch.lora import LoRASpec
from leco_tpu_torch.models.unet import UNetConfig, sd15_config, sdxl_config, tiny_unet_config
from leco_tpu_torch.ops import conv as conv_ops
from leco_tpu_torch.scripts import ab_convfold, bench_convs, bench_pallas_conv, profile_fwd
from leco_tpu_torch.testing import make_random_bundle, tiny_xl_unet_config
from leco_tpu_torch.utils import benchkit
from tests.test_torch_port_unet import port_to_flax

REPO = Path(__file__).resolve().parents[1]
# fp32 carries against the JAX scripts' on the same inputs: relative to
# the reference's largest magnitude (both sum 9 Cin products in fp32)
RTOL_CARRY = 1e-5
# the port's fp32 UNet bound against the JAX package's
# (tests/test_torch_port_unet.py)
ATOL_UNET, RTOL_UNET = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def jax_script(name: str):
    """scripts/<name>.py by path, as the repository's own scripts run it."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured_carry(module, case_fn, *args, **kwargs):
    """The carry function and input that a JAX script's case function hands
    its `bench_fn`, instead of timing them."""
    seen = []
    module.bench_fn = lambda fn, x, iters=64: seen.append((fn, x)) or 1.0
    case_fn(*args, **kwargs)
    (fn, x), = seen
    return fn, np.array(x)  # a writable copy, for torch.from_numpy


def assert_close_rel(got: np.ndarray, want: np.ndarray, rtol: float = RTOL_CARRY):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def jax_conv_weight(cin: int, cout: int) -> np.ndarray:
    """The JAX scripts' HWIO weights: normal(PRNGKey(1)) x 0.02, fp32."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 3, cin, cout), jnp.float32)
                      * 0.02)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# the carry's 0.999 in fp32, and the JAX scripts' `jnp.bfloat16(0.999)`
# (1.0), which im2col_case and matmul_case multiply by whatever the dtype
SCALE = bench_convs.carry_scale(torch.float32, "cpu")
BF16_SCALE = bench_convs.carry_scale(torch.bfloat16, "cpu").float()

# ---------------------------------------------------------------------------
# the chained-carry timer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters,repeats", [(3, 1), (4, 3)])
def test_chained_times_calls_and_carry(iters, repeats):
    """Every call is chained through the carry from x, a warm pass and
    `repeats` timed passes; no device time on the CPU."""
    seen = []

    def fn(c):
        seen.append(int(c))
        return c + 1

    out = benchkit.chained_times(fn, torch.tensor(0), iters, repeats)
    assert seen == list(range(iters)) * (1 + repeats)
    assert out["s"] > 0 and out["device_ms"] is None


def test_chained_times_takes_the_best_of_repeats():
    """Only the first timed pass is slow: the best of 3 is a fast one's,
    the best of 1 the slow one's."""
    def timed(repeats: int) -> float:
        calls = {"n": 0}

        def fn(c):
            calls["n"] += 1
            if 2 < calls["n"] <= 4:  # the first timed pass (calls 3-4 of iters 2)
                time.sleep(0.05)
            return c

        return benchkit.chained_times(fn, torch.zeros(1), iters=2, repeats=repeats)["s"]

    assert timed(1) >= 0.05 / 2 * 0.9
    assert timed(3) < 0.01


def test_chained_times_refuses_empty_runs():
    with pytest.raises(ValueError, match="must be positive"):
        benchkit.chained_times(lambda c: c, torch.zeros(1), iters=0)


# ---------------------------------------------------------------------------
# bench_convs against scripts/bench_convs.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [(2, 8, 16, 16, 1), (2, 8, 16, 24, 1), (2, 8, 16, 8, 1),
                                  (2, 8, 16, 16, 2), (2, 8, 16, 8, 2)],
                         ids=["same", "wider", "narrower", "stride2", "stride2_narrower"])
@pytest.mark.parametrize("layout", ["nchw", "nchw_weight_cl", "channels_last"])
def test_conv_carry_matches_jax(case, layout):
    """`conv_case`'s body (slice or pad back to Cin, x 0.999, a stride-2
    output tiled) in fp32, every layout; the carry keeps the activations'."""
    b, h, cin, cout, stride = case
    jax_bench = jax_script("bench_convs")
    fn, x = captured_carry(jax_bench, jax_bench.conv_case, b, h, cin, cout, stride,
                           dtype=jnp.float32)
    want = np.asarray(fn(jnp.asarray(x)))
    fmt, wfmt = bench_convs.LAYOUTS[layout]
    weight = torch.from_numpy(jax_conv_weight(cin, cout).transpose(3, 2, 0, 1).copy())
    carry = bench_convs.conv_carry(weight.contiguous(memory_format=wfmt), stride, SCALE, fmt)
    got = carry(nchw(x).contiguous(memory_format=fmt))
    assert got.is_contiguous(memory_format=fmt)
    assert_close_rel(nhwc(got), want)


@pytest.mark.parametrize("cout", [16, 8], ids=["same", "narrower"])
def test_im2col_carry_matches_jax(cout):
    b, h, cin = 2, 8, 16
    jax_bench = jax_script("bench_convs")
    fn, x = captured_carry(jax_bench, jax_bench.im2col_case, b, h, cin, cout, dtype=jnp.float32)
    want = np.asarray(fn(jnp.asarray(x)))
    # im2col_case draws its (9 Cin, Cout) matrix from PRNGKey(1) directly
    k = np.array(jax.random.normal(jax.random.PRNGKey(1), (9 * cin, cout), jnp.float32) * 0.02)
    got = bench_convs.im2col_carry(torch.from_numpy(k), BF16_SCALE)(torch.from_numpy(x))
    assert_close_rel(got.numpy(), want)


def test_im2col_is_the_conv():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 6)).astype(np.float32))  # NCHW, H != W
    w = torch.from_numpy(rng.standard_normal((3, 5, 3, 3)).astype(np.float32))
    got = bench_convs.im2col(x.permute(0, 2, 3, 1), bench_convs.im2col_weight(w))
    assert_close_rel(got.permute(0, 3, 1, 2).numpy(), F.conv2d(x, w, padding=1).numpy())


@pytest.mark.parametrize("m,kdim,n", [(32, 16, 24), (32, 24, 16)], ids=["wider", "narrower"])
def test_matmul_carry_matches_jax(m, kdim, n):
    jax_bench = jax_script("bench_convs")
    fn, x = captured_carry(jax_bench, jax_bench.matmul_case, m, kdim, n, dtype=jnp.float32)
    want = np.asarray(fn(jnp.asarray(x)))
    w = np.array(jax.random.normal(jax.random.PRNGKey(1), (kdim, n), jnp.float32) * 0.02)
    got = bench_convs.matmul_carry(torch.from_numpy(w), BF16_SCALE)(torch.from_numpy(x))
    assert_close_rel(got.numpy(), want)


def test_carry_scale_is_the_jax_scripts_bf16_constant():
    """`jnp.bfloat16(0.999)` rounds to 1.0: the bf16 carry is not scaled."""
    assert float(bench_convs.carry_scale(torch.bfloat16, "cpu")) == \
        float(jnp.asarray(jnp.bfloat16(0.999), jnp.float32)) == 1.0


def jax_gemm_cases() -> list:
    """The (M, K, N) list literal of scripts/bench_convs.py's --matmul loop."""
    tree = ast.parse((REPO / "scripts" / "bench_convs.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and [e.id for e in node.target.elts] == ["m", "kdim", "n"]):
            return [tuple(c) for c in ast.literal_eval(node.iter)]
    raise AssertionError("no GEMM loop in scripts/bench_convs.py")


@pytest.mark.parametrize("ours,script,name", [
    (bench_convs.CASES, "bench_convs", "CASES"),
    (bench_pallas_conv.CASES, "bench_pallas_conv", "CASES"),
    (ab_convfold.CASES, "ab_convfold", "CASES"),
    (ab_convfold.SDXL_CASES, "ab_convfold", "SDXL_CASES"),
], ids=["bench_convs", "bench_pallas_conv", "ab_convfold", "ab_convfold_xl"])
def test_case_lists_are_the_jax_scripts(ours, script, name):
    tree = ast.parse((REPO / "scripts" / f"{script}.py").read_text())
    lists = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets if isinstance(t, ast.Name)
             and isinstance(node.value, ast.List)}
    assert ours == lists[name]


def test_gemm_cases_are_the_jax_scripts():
    assert bench_convs.GEMM_CASES == jax_gemm_cases()


def test_bench_convs_record_on_the_cpu(capsys):
    cases = [(2, 8, 16, 16, 1), (2, 8, 16, 8, 2)]
    record = bench_convs.main(["--device", "cpu", "--iters", "2"], cases=cases)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == record
    assert (record["platform"], record["device"], record["mode"]) == ("cpu", None, "conv")
    assert [r["shape"] for r in record["rows"]] == [list(c) for c in cases]
    assert record["rows"][0]["flops"] == 2 * 2 * 8 * 8 * 9 * 16 * 16
    assert record["rows"][1]["flops"] == 2 * 2 * 4 * 4 * 9 * 16 * 8
    assert record["rows"][1]["im2col"] is None  # no im2col form at stride 2
    for row in record["rows"]:
        for key in ("nchw", "nchw_weight_cl", "channels_last", "im2col"):
            if row[key] is not None:
                assert row[key]["ms"] > 0
                # MFU and device time are the card's: none on the CPU
                assert row[key]["mfu"] is row[key]["device_mfu"] is row[key]["device_ms"] is None
    assert set(record["backend_flags"]) == {"cudnn_benchmark", "cudnn_deterministic",
                                            "cudnn_allow_tf32", "matmul_allow_tf32"}


def test_bench_convs_matmul_record_on_the_cpu():
    record = bench_convs.main(["--device", "cpu", "--iters", "2", "--matmul"],
                              cases=[(32, 16, 24)])
    (row,) = record["rows"]
    assert record["mode"] == "matmul" and row["flops"] == 2 * 32 * 16 * 24
    assert row["gemm"]["ms"] > 0 and row["gemm"]["mfu"] is None


# ---------------------------------------------------------------------------
# bench_pallas_conv against scripts/bench_pallas_conv.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cout", [16, 8], ids=["same", "narrower"])
@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_pallas_conv_carries_match_jax(impl, cout):
    """Both columns' bodies against `make_case`'s "xla" body in fp32 (on the
    CPU the kernel column is the kernel's plain version)."""
    b, h, cin = 2, 8, 16
    jax_bench = jax_script("bench_pallas_conv")
    seen = []
    jax_bench.bench_fn = lambda fn, x, iters=64: seen.append((fn, x)) or 1.0
    # make_case is bf16 only: run its body on the fp32 input with fp32 weights
    jax_bench.jnp = SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                       if not k.startswith("__")})
    jax_bench.jnp.bfloat16 = jnp.float32
    jax_bench.make_case(b, h, cin, cout, "xla")
    (fn, x), = seen
    want = np.asarray(fn(jnp.asarray(x)))
    weight = torch.from_numpy(jax_conv_weight(cin, cout).transpose(3, 2, 0, 1).copy())
    carry = bench_pallas_conv.conv_carry(weight, torch.zeros(cout), impl, SCALE)
    assert_close_rel(nhwc(carry(nchw(np.asarray(x)))), want)


def test_bench_pallas_conv_record_on_the_cpu(capsys):
    """The kernel column is the plain conv on the CPU: no launch, no MFU;
    the script counts its kernel-column calls as chained_times makes them."""
    conv_ops.conv3x3_gemm.launches = 0
    cases = [(2, 8, 16, 16), (2, 8, 16, 8)]
    record = bench_pallas_conv.main(["--device", "cpu", "--iters", "2"], cases=cases)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert conv_ops.conv3x3_gemm.launches == 0
    # the check's call and its control's, then a warm and REPEATS timed passes of 2
    assert record["kernel_calls"] == len(cases) * (2 + (1 + bench_pallas_conv.REPEATS) * 2)
    assert record["repeats"] == 3 and record["rtol"] == bench_pallas_conv.RTOL
    assert record["harness_floor"]["ms"] > 0 and record["harness_floor"]["device_ms"] is None
    for row, (b, h, cin, cout) in zip(record["rows"], cases):
        assert row["flops"] == 2 * b * h * h * 9 * cin * cout
        assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
        for impl in ("xla", "kernel"):
            t = row[impl]
            assert t["ms"] > 0
            assert t["mfu"] is t["mfu_adjusted"] is t["device_mfu"] is t["device_ms"] is None
        assert row["speedup"] > 0
        assert row["repack_device_ms"] is row["device_speedup"] is None
        check = row["check"]
        assert check["max_abs_err"] <= check["limit"] < check["control_max_abs_err"]


def _check_inputs(b=2, h=8, cin=16, cout=8):
    x = bench_convs.seeded_randn((b, cin, h, h), 0, torch.float32, "cpu")
    weight = bench_convs.seeded_randn((cout, cin, 3, 3), 1, torch.float32, "cpu",
                                      bench_convs.WEIGHT_SCALE)
    return x, weight, torch.zeros(cout)


def test_output_check_holds_the_kernel_and_its_control():
    """The kernel column (its plain version on the CPU) within RTOL x max|ref|
    of F.conv2d, the flipped-tap control past it; both kernel calls counted."""
    counter = {"n": 0}
    check = bench_pallas_conv.output_check(*_check_inputs(), counter)
    assert check["max_abs_err"] <= check["limit"] < check["control_max_abs_err"]
    assert counter["n"] == 2


@pytest.mark.parametrize("wrong,why", [
    (lambda x, w, b: F.conv2d(x, w, None, 1, 1) * 1.05, "past"),
    (lambda x, w, b: F.conv2d(x, w.flip(2, 3), None, 1, 1), "past"),
    (lambda x, w, b: F.conv2d(x, w.sum((2, 3), keepdim=True).expand_as(w) / 9, None, 1, 1),
     "past"),
], ids=["scaled", "flipped_taps", "taps_averaged"])
def test_output_check_refuses_a_wrong_kernel(monkeypatch, wrong, why):
    """A kernel that is off the conv raises before any time is taken."""
    monkeypatch.setattr(conv_ops, "conv3x3", wrong)
    with pytest.raises(RuntimeError, match=why):
        bench_pallas_conv.output_check(*_check_inputs())


def test_output_check_refuses_a_control_that_passes(monkeypatch):
    """A kernel blind to its taps' order passes its control: the check has
    no teeth there and raises."""
    def tap_blind(x, w, b):
        w = w.flatten(2).sort(dim=-1).values.view_as(w)
        return F.conv2d(x, w, None, 1, 1)

    x, weight, bias = _check_inputs()
    weight = weight.flatten(2).sort(dim=-1).values.view_as(weight).contiguous()
    monkeypatch.setattr(conv_ops, "conv3x3", tap_blind)
    with pytest.raises(RuntimeError, match="control"):
        bench_pallas_conv.output_check(x, weight, bias)


def test_adjusted_mfu_takes_the_floor_off():
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS

    flops = BF16_TENSOR_FLOPS * 1e-3  # 1 ms at peak
    assert bench_pallas_conv.adjusted_mfu(flops, 4e-3, 0.0) == pytest.approx(0.25)
    assert bench_pallas_conv.adjusted_mfu(flops, 4e-3, 2e-3) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# ab_convfold against scripts/ab_convfold.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,cin,cout", [(8, 4, 6), (5, 3, 3), (16, 8, 4)])
def test_fold_is_bitwise_in_float64_and_the_seamless_control_is_not(h, cin, cout):
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.standard_normal((2, cin, h, h)))
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)))
    ref = F.conv2d(x, w, padding=1)
    assert ab_convfold.fold(x).shape == (1, cin, 2 * h + ab_convfold.SEAM, h)
    assert torch.equal(ab_convfold.folded_conv(x, w), ref)
    control = ab_convfold.folded_conv(x, w, seam=0)
    # the windows cross samples on each sample's inner border row only
    assert not torch.equal(control, ref)
    assert torch.equal(control[0, :, :h - 1], ref[0, :, :h - 1])
    assert torch.equal(control[1, :, 1:], ref[1, :, 1:])


@pytest.mark.parametrize("side", ["plain", "folded"])
@pytest.mark.parametrize("cout", [16, 8], ids=["same", "narrower"])
def test_fold_carries_match_jax(side, cout):
    h, cin = 8, 16
    jax_ab = jax_script("ab_convfold")
    case = jax_ab.plain_case if side == "plain" else jax_ab.folded_case
    fn, x = captured_carry(jax_ab, case, h, cin, cout, dtype=jnp.float32)
    want = np.asarray(fn(jnp.asarray(x)))
    weight = torch.from_numpy(jax_conv_weight(cin, cout).transpose(3, 2, 0, 1).copy())
    carry = ab_convfold.plain_carry if side == "plain" else ab_convfold.folded_carry
    assert_close_rel(nhwc(carry(weight, SCALE)(nchw(x))), want)


def test_ab_convfold_record_on_the_cpu(capsys):
    cases = [(8, 16, 16), (8, 16, 8)]
    record = ab_convfold.main(["--device", "cpu", "--iters", "2"], cases=cases)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    pin = record["pin"]
    assert pin["shape"] == [2, 64, 16, 16, 64]
    assert pin["max_abs_diff"] <= pin["limit"] < pin["control_max_abs_diff"]
    plain = sum(r["plain"]["ms"] for r in record["rows"])
    assert record["total"]["plain"]["ms"] == pytest.approx(plain)
    assert record["total"]["fold_over_plain"] == pytest.approx(
        record["total"]["folded"]["ms"] / plain)
    assert record["total"]["plain"]["device_ms"] is None


def test_ab_convfold_refuses_a_batch_it_cannot_fold():
    with pytest.raises(ValueError, match="stacks 2 samples"):
        ab_convfold.fold(torch.zeros(3, 1, 4, 4))


# ---------------------------------------------------------------------------
# profile_fwd against scripts/profile_fwd.py and the JAX package's UNet
# ---------------------------------------------------------------------------


def perturbed_bundle(config: UNetConfig, seed: int = 0):
    """The tiny random bundle in fp32 with every parameter, the LoRA's up
    included, moved 0.05 N(0, 1) off its init (a zero lora_up would hide
    the fold)."""
    bundle = make_random_bundle(config=config, spec=LoRASpec(rank=4, alpha=1.0),
                                attn_backend="flash")
    rng = np.random.default_rng(seed)
    state = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in bundle.unet.state_dict().items()}
    bundle.unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return bundle, state


@pytest.mark.parametrize("which,res", [("sd", 128), ("sdxl", 256)])
def test_profiled_forward_matches_the_jax_unet(which, res):
    """profile_fwd's first call (the LoRA folded) against the JAX script's
    forward, `unet.apply` on `merge_params(base, lora)` at t 500, on the
    same weights and inputs; 128 / 256 px give the flash route 256 tokens."""
    config = tiny_unet_config() if which == "sd" else tiny_xl_unet_config()
    bundle, state = perturbed_bundle(config)
    x, ctx, added = profile_fwd.forward_inputs(config, res, 2, "cpu", torch.float32)
    run = profile_fwd.capture(bundle.unet, x, ctx, added, n_calls=1)
    assert run["calls"] == 1 + profile_fwd.WALL_CALLS + 1
    got = nhwc(run["first"])

    spec = jax_lora.LoRASpec(rank=4, alpha=1.0)
    base, lora_tree = jax_lora.split_lora_params(port_to_flax(state))
    jax_cfg = JaxUNetConfig(**{f: getattr(config, f) for f in UNetConfig.__dataclass_fields__})
    jax_added = None if added is None else {k: jnp.asarray(v.numpy()) for k, v in added.items()}
    want = JaxUNet(config=jax_cfg, lora_spec=spec).apply(
        {"params": jax_lora.merge_params(base, lora_tree)},
        jnp.asarray(nhwc(x)), profile_fwd.TIMESTEP, jnp.asarray(ctx.numpy()), jax_added)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_UNET, rtol=RTOL_UNET)


@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_forward_inputs_are_the_jax_scripts(model):
    """Shapes of `capture`'s inputs (profile_fwd.py:40-52); SDXL's pooled
    width is projection_class_embeddings_input_dim - 6 x
    addition_time_embed_dim and its time_ids [res, res, 0, 0, res, res]."""
    config = sd15_config() if model == "sd15" else sdxl_config()
    x, ctx, added = profile_fwd.forward_inputs(config, 64, 2, "cpu", torch.bfloat16)
    assert x.shape == (2, 4, 8, 8) and x.dtype == torch.bfloat16
    assert ctx.shape == (2, 77, config.cross_attention_dim)
    again = profile_fwd.forward_inputs(config, 64, 2, "cpu", torch.bfloat16)
    assert torch.equal(x, again[0]) and torch.equal(ctx, again[1])  # seeded draws
    if model == "sd15":
        assert added is None
        return
    assert added["text_embeds"].shape == (2, 1280) and not added["text_embeds"].any()
    assert added["time_ids"].tolist() == [[64, 64, 0, 0, 64, 64]] * 2


def device_event(i: int, name: str, start: float, end: float, scope: bool = False):
    return FunctionEvent(id=i, name=name, thread=0, start_us=start, end_us=end,
                         use_device="cuda", device_type=DeviceType.CUDA,
                         is_user_annotation=scope)


def synthetic_forwards():
    """Two traced forwards: per call a flash forward in attn1's core, a
    conversion and a cuDNN conv in resnet conv1, a GEMM in the forward but
    in no component, each forward inside its unet/other scope."""
    events, i = [], 0
    for call, t0 in enumerate((0.0, 100.0)):
        for name, start, end, scope in (
                ("flash_fwd_kernel(CUtensorMap, int)", 0, 10, False),
                ("void cudnn::engines_precompiled::nchwToNhwcKernel<>", 20, 24, False),
                ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 24, 40, False),
                ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 50, 60, False),
                ("leco/unet/other", 0, 60, True),
                ("leco/attn1(self)/core", 0, 10, True),
                ("leco/resnet/conv1", 20, 40, True)):
            i += 1
            events.append(device_event(i, name, t0 + start, t0 + end, scope))
    return events


def test_analyze_a_synthetic_trace(tmp_path, monkeypatch, capsys):
    dump = tmp_path / "fwd_ops.json"
    monkeypatch.setenv("LECO_PROFILE_DUMP", str(dump))
    monkeypatch.setattr(profile_fwd, "TOP", 2)
    out = profile_fwd.analyze(synthetic_forwards(), n_calls=2, wall_s=100e-6)
    assert out["profiled_calls"] == 2
    assert out["device_busy_s"] == pytest.approx(40e-6)
    assert out["device_idle_share"] == pytest.approx(0.6)
    assert (out["kernel_launches"], out["component_scopes"]) == (4, 3)
    assert len(out["top_kernels"]) == 4  # every kernel kept; the print shows TOP
    assert out["top_kernels"][0][1:] == [pytest.approx(0.016), 1]
    share = {k: v[1] for k, v in out["by_category_ms_share"].items()}
    assert share == pytest.approx({"kernel 1/4 flash forward (3-d, packed)": 0.25,
                                   "NCHW<->NHWC": 0.1, "cuDNN conv": 0.4, "cuBLAS GEMM": 0.25})
    components = {k: v[0] for k, v in out["by_component_ms_share"].items()}
    assert components == pytest.approx({"resnet/conv1": 0.020, "attn1(self)/core": 0.010,
                                        "unet/other": 0.010})
    written = json.loads(dump.read_text())
    assert written["components"] == pytest.approx(components)
    assert written["kernels"] == pytest.approx({k[:90]: ms for k, ms, _ in out["top_kernels"]})
    printed = capsys.readouterr().out
    assert "== top 2 kernels (per call) ==" in printed and "x1" in printed
    table = printed.split("== top 2 kernels (per call) ==")[1].split("per-kernel")[0]
    assert len([line for line in table.splitlines() if " ms " in line]) == 2


def test_main_on_the_cpu_raises_for_no_device_time_and_removes_its_hooks(tmp_path):
    """The CPU run goes through capture (the trace written, every call
    made), then analyze refuses it; the component hooks are gone."""
    bundle = make_random_bundle()
    calls = []
    bundle.unet.register_forward_pre_hook(lambda mod, args: calls.append(1))
    with pytest.raises(RuntimeError, match="no device time"):
        profile_fwd.main(["--device", "cpu", "--res", "64", "--batch", "1",
                          "--logdir", str(tmp_path)], bundle=bundle)
    assert len(calls) == 1 + profile_fwd.WALL_CALLS + profile_fwd.N_CALLS
    assert (tmp_path / "trace.json").exists()
    hooks = [m for m in bundle.unet.modules() if m._forward_hooks or m._forward_pre_hooks]
    assert hooks == [bundle.unet]  # the test's own pre-hook alone


def test_component_hooks_are_removed_when_a_profiled_forward_raises():
    """A forward that raises inside the profiled calls (in a down block, once
    the UNet's scope is open) leaves no component hook behind, and the LoRA
    unfolded."""
    bundle = make_random_bundle()
    calls = []

    def fail_when_profiled(mod, args):
        calls.append(1)
        if len(calls) == 1 + profile_fwd.WALL_CALLS + 1:
            raise RuntimeError("a fault in the first profiled call")

    handle = bundle.unet.down_blocks[0].register_forward_pre_hook(fail_when_profiled)
    x, ctx, _ = profile_fwd.forward_inputs(bundle.unet.cfg, 64, 1, "cpu", torch.float32)
    with pytest.raises(RuntimeError, match="first profiled call"):
        profile_fwd.capture(bundle.unet, x, ctx, None, n_calls=2)
    handle.remove()
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in bundle.unet.modules())
    assert {m.mode for m in bundle.unet.modules() if hasattr(m, "lora_down")} == {"on"}


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", [profile_fwd.main, bench_convs.main, bench_pallas_conv.main,
                                   ab_convfold.main],
                         ids=["profile_fwd", "bench_convs", "bench_pallas_conv", "ab_convfold"])
def test_entry_points_refuse_cuda_without_a_gpu(entry):
    """Every entry point defaults to --device cuda and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry([])
