"""The sharded layers of `leco_tpu_torch.parallel` against the same layers
unsharded, forward and backward, on 2 gloo ranks (one spawn for every
check, `leco_tpu_torch.parallel.testing`'s "ops" job).

Spatial parallelism (H over sp, each rank holding half the rows): the 3x3
conv at stride 1, the stride-2 downsample and the pre-upsample conv, both
as phase convolutions (its LoRA folded) and materialised with the LoRA
branch on, each with its c3lier LoRA branch; GroupNorm + SiLU; self-
attention over 256 tokens (128 a rank) on the flash route (the kernels'
plain versions), on the plain route, and on the flash route with the plain
backward (`LECO_FLASH_BWD=xla`); cross-attention under `LECO_FLASH_CROSS=1`.
Tensor parallelism (tp 2): a transformer whose heads divide tp (every
q/k/v/out and GEGLU layer sharded, the GEGLU's value and gate halves each
split) and one with 3 heads (its attentions replicated, its feed-forward
sharded), with the folded inner-loop weights.

fp32 throughout. The halo rows and the gathers are exact; the sums over the
ranks (GroupNorm's statistics, the gradients of shared weights, the
row-parallel partials) run in other orders, so each tensor is held to
1e-5 x its largest magnitude.
"""

import numpy as np
import pytest
import torch

from leco_tpu_torch.parallel import testing as ptesting

SP_CHECKS = ("conv_stride1", "conv_stride2", "upsample_phase", "upsample_lora_on",
             "group_norm", "attention_flash", "attention_plain",
             "attention_flash_plain_backward", "cross_attention_flash_cross")
TP_CHECKS = ("tp_transformer", "tp_transformer_odd_heads")
RTOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ptesting.spawn({"kind": "ops"}, 2, tmp_path_factory.mktemp("ops"))


def _close(got, want, what):
    assert got is not None and got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-12)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=RTOL_OF_MAX * scale, rtol=0, err_msg=what)


def test_rank_processes_import_neither_jax_nor_the_tests(ranks):
    assert [r["foreign_modules"] for r in ranks] == [[], []]


@pytest.mark.parametrize("check", SP_CHECKS)
def test_spatial_layer_matches_unsharded(check, ranks):
    for r, result in enumerate(ranks):
        got, want = result[check]["got"], result[check]["want"]
        assert set(want) >= {"y", "dx"} and len(want) > 2  # parameters' gradients too
        for key, w in want.items():
            _close(got[key], w, f"{check} {key} on rank {r}")


@pytest.mark.parametrize("check,fwd,bwd", [
    ("attention_flash", 2, 2),
    ("attention_flash_plain_backward", 2, 0),
    ("cross_attention_flash_cross", 2, 2),
    ("attention_plain", 0, 0),
])
def test_sp_attention_routes_on_the_global_token_count(check, fwd, bwd, ranks):
    """128 query rows a rank, 256 in all: the sharded layer takes the flash
    route as the unsharded one does (one forward each, and the kernels'
    backward pair unless LECO_FLASH_BWD sends it to the plain one)."""
    for result in ranks:
        calls = result[check]["calls"]
        assert (calls["attn_fwd_plain"], calls["attn_bwd_dq_plain"],
                calls["attn_bwd_dkv_plain"]) == (fwd, bwd, bwd)


@pytest.mark.parametrize("check", TP_CHECKS)
def test_tensor_parallel_transformer_matches_unsharded(check, ranks):
    for r, result in enumerate(ranks):
        got, want = result[check]["got"], result[check]["want"]
        assert any(".lora_" in k for k in want)
        for key, w in want.items():
            _close(got[key], w, f"{check} {key} on rank {r}")


@pytest.mark.parametrize("check", TP_CHECKS)
def test_every_tp_rank_holds_bitwise_the_same_lora_gradients(check, ranks):
    first, second = (r[check]["got"] for r in ranks)
    for key, value in first.items():
        if ".lora_" in key:
            assert torch.equal(value, second[key]), key


def test_tp_plan_keeps_heads_whole(ranks):
    """Heads that divide tp: every q/k/v/out and GEGLU layer of both
    attentions sharded; 3 heads at tp 2: the attentions replicated (JAX's
    rule would shard their divisible widths; GSPMD reshards), the
    feed-forward sharded."""
    block = "attentions.0.transformer_blocks.0"
    full = {f"{block}.{a}.{p}": k for a in ("attn1", "attn2")
            for p, k in (("to_q", "column"), ("to_k", "column"), ("to_v", "column"),
                         ("to_out.0", "row"))}
    feed = {f"{block}.ff.net.0.proj": "column", f"{block}.ff.net.2": "row"}
    for result in ranks:
        assert result["tp_transformer"]["plan"] == {**full, **feed}
        assert result["tp_transformer_odd_heads"]["plan"] == feed
