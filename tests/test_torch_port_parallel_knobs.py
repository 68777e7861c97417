"""The JAX package's fused-kernel knobs under the port's tensor and spatial
parallelism.

The slice as a whole: the port's knobs-on train step (`LECO_CONV_BACKEND=
gemm`, `LECO_RESNET_FUSED=1`, `LECO_TPU_FUSED_GN=1`, `LECO_GEGLU=fused`,
`LECO_FLASH_PACKED=1`) on gloo ranks (`leco_tpu_torch.parallel.testing`,
fresh spawns: 2 ranks for sp 2, tp 2 and tp 2 on the tiny SDXL UNet, 4 for
dp x sp 2 x 2 and sp 4) against the JAX package's *unsharded* knobs-on step
on the same weights, prompt embeddings and latents (the `sd_b1` / `xl_b1`
cases of tests/test_torch_port_parallel_step.py). The JAX step runs its
Pallas kernels in interpret mode with `LECO_LORA_FUSE=0`, and its gates
opened as tests/test_torch_port_fused_path.py opens them, but with the
gnconv gate's 4 <= H, W <= 16 kept (as in the ranks, whose gates only lose
their 128-channel floors). `LECO_FLASH_PACKED=1` does not run on the JAX
side on the CPU: its UNet takes the plain attention there (`default_backend`
is "xla"), which is the same function as the packed kernel, so the oracle
is the JAX step without it. At sp 4 the tiny UNet's 8 x 8 level holds 2 rows
a rank, which the gnconv gate must judge on the global H (8) as the JAX
gate does under jit, and the halo conv runs on h = 2.

Tolerances are tests/test_torch_port_parallel_step.py's (fp32): rtol 1e-4
on the loss, 1e-4 x max|g| on each LoRA gradient. Every rank ends with bitwise the same LoRA and calls each
kernel's plain version as often as the unsharded port step does (a row
window is the same kernel's other entry; a split GroupNorm counts once, its
statistics and apply calls equal).

The layers: each sharded route of the knobs on 2 ranks beside the same
layer unsharded, forward and backward, at 1e-5 x the largest magnitude
(tests/test_torch_port_parallel_ops.py's bound), with its plain versions'
calls, and the two controls (`gnconv_edge_unmasked`, `gn_stats_local`),
which must fail it. In-process: the row-window conv and GroupNorm-SiLU-conv
plain versions at h = 2 and 8 with each edge flag against the padded plain
versions (and the JAX `_gnconv_kernel` through `affine_silu_conv` in
interpret mode, atol 1e-4 in fp32 as tests/test_torch_port_gn_conv.py), the
split GroupNorm against `group_norm_silu_plain` and the JAX
`group_norm_silu_ref` (atol 1e-5), and the gnconv gate at sp 4.
"""

import concurrent.futures
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.lora import LoRAConv as JaxLoRAConv
from leco_tpu.ops import gn_conv as jgc
from leco_tpu.ops import group_norm as jgn
from leco_tpu_torch.lora import LoRAConv2d
from leco_tpu_torch.ops import conv, gn_conv
from leco_tpu_torch.ops import group_norm as gn
from leco_tpu_torch.parallel import testing as ptesting
from tests.test_torch_port_parallel_step import CASES, LR, _case, _jax_step, _job
from tests.test_torch_port_train_step import _flax_layout
from test_torch_port_fused_path import _jax_hot_3x3

KNOBS = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1", "LECO_TPU_FUSED_GN": "1",
         "LECO_GEGLU": "fused", "LECO_FLASH_PACKED": "1"}
# name: (case, (inner axis, size)) on 2 ranks, and on 4
TWO_RANKS = {"sp2_b1_knobs": ("sd_b1", ("sp", 2)), "tp2_b1_knobs": ("sd_b1", ("tp", 2)),
             "tp2_xl_b1_knobs": ("xl_b1", ("tp", 2))}
FOUR_RANKS = {"dp2_sp2_b1_knobs": ("sd_b1", ("sp", 2)), "sp4_b1_knobs": ("sd_b1", ("sp", 4))}
STEPS = {**{k: (2, v) for k, v in TWO_RANKS.items()}, **{k: (4, v) for k, v in FOUR_RANKS.items()}}
SP_CHECKS = ("conv_gemm", "resnet_gnconv", "group_norm_fused", "attention_packed")
RTOL_OF_MAX = 1e-5


def _jax_gnconv_gate(shape, cout, dtype):
    """The JAX gate without its 128-channel floor: 4 <= H, W <= 16 (NHWC)."""
    return 4 <= shape[1] <= gn_conv.MAX_FUSED_SIDE and 4 <= shape[2] <= gn_conv.MAX_FUSED_SIDE


def _interpreted_jax_step(*args):
    with pltpu.force_tpu_interpret_mode():
        return _jax_step(*args)


def _steps(steps: dict) -> dict:
    return {k: (c, mesh, {"knobs": KNOBS, "open_gates": True}) for k, (c, mesh) in steps.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The knob ops and the ranks' steps (fresh spawns), the JAX package's
    unsharded knobs-on steps (compiled in threads while the ranks run) and
    the port's own unsharded knobs-on steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {**KNOBS, "LECO_LORA_FUSE": "0", "LECO_GNCONV_INTERPRET": "1"}.items():
            mp.setenv(k, v)
        mp.setattr(jgc, "supports", _jax_gnconv_gate)
        mp.setattr(JaxLoRAConv, "_is_hot_3x3", _jax_hot_3x3)
        names = {c for c, _ in TWO_RANKS.values()} | {c for c, _ in FOUR_RANKS.values()}
        built = {name: _case(*CASES[name]) for name in sorted(names)}
        cases = {name: case for name, (case, _) in built.items()}
        running = {"ops": ptesting.Running({"kind": "knob_ops"}, 2,
                                           tmp_path_factory.mktemp("knob_ops"))}
        for world, steps in ((2, TWO_RANKS), (4, FOUR_RANKS)):
            running[world] = ptesting.Running(_job(cases, _steps(steps)), world,
                                              tmp_path_factory.mktemp(f"knobs{world}"))
        with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:
            futures = {name: pool.submit(_interpreted_jax_step, *args)
                       for name, (_, args) in built.items()}
            jax_steps = {name: f.result() for name, f in futures.items()}
        unsharded = {}
        with ptesting.open_gates():
            for name, case in cases.items():
                unet, spec = ptesting.build_unet(case, torch.device("cpu"))
                unsharded[name] = ptesting.step_once(unet, spec, case, torch.device("cpu"), LR)
        ranks = {"ops": running.pop("ops").results()}
        for world, handle in running.items():
            results = handle.results()
            for name in (TWO_RANKS if world == 2 else FOUR_RANKS):
                ranks[name] = [r[name] for r in results]
            ranks[f"foreign_modules_{world}"] = [r["foreign_modules"] for r in results]
    torch.set_num_threads(threads)
    return {"ranks": ranks, "jax": jax_steps, "unsharded": unsharded}


@pytest.fixture(scope="module")
def ranks(run):
    return run["ranks"]


def test_rank_processes_import_neither_jax_nor_the_tests(ranks):
    assert [r["foreign_modules"] for r in ranks["ops"]] == [[], []]
    assert ranks["foreign_modules_2"] == [[], []]
    assert ranks["foreign_modules_4"] == [[]] * 4


@pytest.mark.parametrize("name", list(STEPS))
def test_knobs_on_sharded_loss_matches_unsharded_jax(name, ranks, run):
    want = run["jax"][STEPS[name][1][0]]["loss"]
    for r, result in enumerate(ranks[name]):
        assert np.isfinite(result["loss"])
        np.testing.assert_allclose(result["loss"], want, rtol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(STEPS))
def test_knobs_on_sharded_gradients_match_unsharded_jax(name, ranks, run):
    want = run["jax"][STEPS[name][1][0]]["grads"]
    for r, result in enumerate(ranks[name]):
        assert set(result["grads"]) == set(want)
        for leaf, g in want.items():
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(_flax_layout(leaf, result["grads"][leaf]), g,
                                       atol=1e-4 * scale, err_msg=f"{leaf} on rank {r}")
            assert np.abs(g).max() > 0, leaf


@pytest.mark.parametrize("name", list(STEPS))
def test_every_rank_ends_with_bitwise_the_same_lora(name, ranks):
    first = ranks[name][0]
    for result in ranks[name][1:]:
        for leaf, v in first["lora"].items():
            assert torch.equal(result["lora"][leaf], v), leaf


@pytest.mark.parametrize("name", list(STEPS))
def test_every_rank_calls_each_kernel_as_the_unsharded_step(name, ranks, run):
    """The unsharded knobs-on step runs every fused kernel and the packed
    forward (self-attention takes the packed route, so no 3-d flash call);
    each rank calls each kernel's plain version as often, a split GroupNorm
    once (its statistics as often as its apply)."""
    calls = run["unsharded"][STEPS[name][1][0]]["calls"]
    want = ptesting.per_kernel(calls, plain=True)
    assert all(want[k] > 0 for k in ("attn_fwd_packed", "conv3x3", "gnconv3x3",
                                     "group_norm", "geglu")), want
    assert calls["group_norm_stats_plain"] == calls["group_norm_apply_plain"] == 0
    sp = STEPS[name][1][1][0] == "sp"
    for result in ranks[name]:
        got = result["calls"]
        assert ptesting.per_kernel(got, plain=True) == want
        assert got["group_norm_stats_plain"] == got["group_norm_apply_plain"]
        # under sp every conv and GroupNorm takes its row-window or split entry
        assert (got["conv3x3_rows_plain"] > 0) == sp
        assert (got["gnconv3x3_rows_plain"] == want["gnconv3x3"]) == sp
        assert (got["group_norm_apply_plain"] == want["group_norm"]) == sp


# ---------------------------------------------------------------------------
# the layers on 2 ranks
# ---------------------------------------------------------------------------


def _close(got, want, what):
    assert got is not None and got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-12)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=RTOL_OF_MAX * scale, rtol=0, err_msg=what)


def _worst(result) -> float:
    return max(float((result["got"][k] - w).abs().max() / max(float(w.abs().max()), 1e-12))
               for k, w in result["want"].items())


@pytest.mark.parametrize("check", SP_CHECKS)
def test_sp_knob_layer_matches_unsharded(check, ranks):
    for r, result in enumerate(ranks["ops"]):
        got, want = result[check]["got"], result[check]["want"]
        assert set(want) >= {"y", "dx"} and len(want) > 2  # parameters' gradients too
        for key, w in want.items():
            _close(got[key], w, f"{check} {key} on rank {r}")


@pytest.mark.parametrize("check,calls", [
    # unsharded: forward and dx on the padded entry; sharded: the forward on
    # the row window, its dx on the padded entry over the h + 2 rows
    ("conv_gemm", {"conv3x3_gemm_plain": 3, "conv3x3_rows_plain": 1}),
    ("resnet_gnconv", {"gnconv3x3_plain": 2, "gnconv3x3_rows_plain": 2}),
    ("group_norm_fused", {"group_norm_silu_plain": 1, "group_norm_stats_plain": 1,
                          "group_norm_apply_plain": 1}),
    ("attention_packed", {"attn_fwd_packed_plain": 2}),
])
def test_sp_knob_layer_takes_the_kernels(check, calls, ranks):
    for result in ranks["ops"]:
        got = {k: v for k, v in result[check]["calls"].items()
               if v and not k.startswith("launches_")}
        assert got == calls


@pytest.mark.parametrize("control,check", [("gnconv_edge_unmasked", "resnet_gnconv"),
                                           ("gn_stats_local", "group_norm_fused")])
def test_knob_controls_fail(control, check, ranks):
    """The zero halo rows past the image's edges through the activation
    (silu(s) where the padding is 0), and the GroupNorm statistics of the
    rank's rows alone, each miss the unsharded layer by far more than the
    bound; the same routes run."""
    assert control in ptesting.KNOB_CONTROLS
    for result in ranks["ops"]:
        assert _worst(result[f"control_{control}"]) > 100 * RTOL_OF_MAX
        assert result[f"control_{control}"]["calls"] == result[check]["calls"]


def test_tp_packed_attention_and_geglu_match_unsharded(ranks):
    """A transformer over 256 tokens at tp 2: self-attention on the packed
    kernel over each rank's head, the GEGLU kernel on the rank's [value |
    gate] columns (N = 32 / 2), the GroupNorm kernel replicated."""
    for r, result in enumerate(ranks["ops"]):
        res = result["tp_transformer_knobs"]
        assert any(".lora_" in k for k in res["want"])
        for key, w in res["want"].items():
            _close(res["got"][key], w, f"tp {key} on rank {r}")
        calls = {k: v for k, v in res["calls_got"].items() if v and not k.startswith("launches_")}
        assert calls == {"attn_fwd_packed_plain": 1, "geglu_gemm_plain": 1,
                         "group_norm_silu_plain": 1}
        assert res["calls_want"] == res["calls_got"]
        assert "attentions.0.transformer_blocks.0.ff.net.0.proj" in res["plan"]


# ---------------------------------------------------------------------------
# in-process: the plain versions of the new entries, and the gate
# ---------------------------------------------------------------------------


def _image(b, c, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, c, h, w)).astype(np.float32) + rng.standard_normal(
        (1, c, 1, 1)).astype(np.float32)


def _window(x: torch.Tensor, start: int, h: int) -> torch.Tensor:
    """Rows start - 1 .. start + h of x, zero rows past its edges."""
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1))
    return padded[:, :, start:start + h + 2].contiguous()


# (h, start of the rank's rows) in an image of 3h rows (and the whole image)
WINDOWS = [(2, 0), (2, 2), (2, 4), (8, 0), (8, 8), (8, 16), (6, "whole")]


@pytest.mark.parametrize("h,start", WINDOWS)
def test_row_window_conv_plain_is_the_padded_conv_on_its_rows(h, start):
    rows = h if start == "whole" else 3 * h
    start = 0 if start == "whole" else start
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_image(2, 16, rows, 12, 0))
    wt = torch.from_numpy(0.1 * rng.standard_normal((8, 16, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    want = conv.conv3x3_gemm_plain(x, wt, bias)[:, :, start:start + h]
    got = conv.conv3x3_rows_plain(_window(x, start, h), wt, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.fixture
def _gnconv_interpret(monkeypatch):
    monkeypatch.setenv("LECO_GNCONV_INTERPRET", "1")


@pytest.mark.parametrize("h,start", WINDOWS)
def test_row_window_gnconv_plain_is_the_jax_kernel_on_its_rows(h, start, _gnconv_interpret):
    """The edge flags from the window's place: the first row is padding at
    the image's top, the last at its bottom. Held to the padded plain
    version (1e-5) and to the JAX kernel `_gnconv_kernel` in interpret mode
    on the whole image (1e-4, fp32, tests/test_torch_port_gn_conv.py's)."""
    rows = h if start == "whole" else 3 * h
    start = 0 if start == "whole" else start
    top, bottom = start > 0, start + h < rows
    rng = np.random.default_rng(2)
    x = _image(1, 128, rows, 8, 3)
    a = (1.0 + 0.1 * rng.standard_normal((1, 128))).astype(np.float32)
    s = (0.5 * rng.standard_normal((1, 128))).astype(np.float32)
    wt = (0.05 * rng.standard_normal((128, 128, 3, 3))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    tx, ta, ts, tw, tb = map(torch.from_numpy, (x, a, s, wt, bias))
    got = gn_conv.gnconv3x3_rows_plain(_window(tx, start, h), ta, ts, tw, tb, True, top, bottom)
    padded = gn_conv.gnconv3x3_plain(tx, ta, ts, tw, tb)[:, :, start:start + h]
    np.testing.assert_allclose(got.numpy(), padded.numpy(), atol=1e-5)
    want = jgc.affine_silu_conv(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(a),
                                jnp.asarray(s), jnp.asarray(wt.transpose(2, 3, 1, 0)),
                                jnp.asarray(bias))
    want = np.asarray(want).transpose(0, 3, 1, 2)[:, :, start:start + h]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if top or bottom:
        return
    # the control: a padding row taken for an image row is silu(s), not 0
    unmasked = gn_conv.gnconv3x3_rows_plain(_window(tx, start, h), ta, ts, tw, tb, True,
                                            True, True)
    assert float((unmasked - padded).abs().max()) > 1e-2


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("ranks_", [2, 4])
def test_split_group_norm_plain_is_the_reference(ranks_, silu):
    """Each rank's S and SQ summed over the ranks, then the normalisation
    of each rank's rows with the global count: the one-launch plain version
    (1e-5) and the JAX `group_norm_silu_ref` (1e-5, fp32); the statistics of
    one rank's rows alone (the `gn_stats_local` control) miss it."""
    x = torch.from_numpy(_image(2, 16, 8, 6, 4))
    scale = torch.linspace(0.5, 1.5, 16)
    bias = torch.linspace(-0.2, 0.2, 16)
    parts = x.chunk(ranks_, dim=2)
    sums = sum(gn.group_norm_stats_plain(p, 4) for p in parts)
    count = 4 * 8 * 6  # C / G x H x W
    got = torch.cat([gn.group_norm_apply_plain(p, scale, bias, sums, count, 1e-5, silu)
                     for p in parts], dim=2)
    want = gn.group_norm_silu_plain(x, scale, bias, 4, 1e-5, silu)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    ref = jgn.group_norm_silu_ref(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                                  jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()), 4,
                                  1e-5, silu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5)
    local = gn.group_norm_apply_plain(parts[0], scale, bias, gn.group_norm_stats_plain(
        parts[0], 4), count // ranks_, 1e-5, silu)
    assert float((local - want[:, :, :8 // ranks_]).abs().max()) > 1e-2


@pytest.mark.parametrize("local_h,sp,fused", [(2, 4, True), (2, 1, False), (4, 4, True),
                                              (8, 4, False), (16, 1, True), (1, 4, True)])
def test_gnconv_gate_decides_on_the_global_h(local_h, sp, fused):
    """At sp 4 SD1.5's 8 x 8 level holds 2 rows a rank: the gate admits it
    as the JAX gate does (global H 8), where the rank's 2 rows alone would
    be refused; 8 rows a rank at sp 4 is H 32, refused."""
    layer = LoRAConv2d(128, 128, 3, padding=1)
    layer.parallel = types.SimpleNamespace(spatial=sp > 1, global_rows=lambda h: h * sp)
    assert layer.fuses_group_norm(torch.zeros(1, 128, local_h, 8)) == fused
