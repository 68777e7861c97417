"""The rules of `leco_tpu_torch.parallel` against the JAX package's, with no
process spawned: the JAX side runs on the 8 virtual CPU devices that
tests/conftest.py forces.

  * the tp rule table (`sharding.param_spec`) against `unet_param_spec` with
    `shard_unet_params`'s divisibility guard, read off the shardings that
    `shard_unet_params` puts on every base leaf of the tiny SD and SDXL
    UNets, mapped through the converter (a flax kernel is (in, out));
  * the port's refinement of it (`tp_plan`): whole heads only, on SD2.1's
    and SDXL's real configs;
  * `internal_plan` and `shardable_batch` against `constrain_internal` and
    `shardable_batch` for the step's internal batches;
  * the rank grid against `make_mesh_2d` / `get_mesh_dp_sp`'s device grids;
  * the CLIs' mesh choice (sp auto, the tp/sp exclusivity);
  * `shared_seed` at world size 1 against `_multihost_shared_seed`;
  * the port's own rules: the fused knobs run under dp, sp and tp, each on
    its kernel route, and a call whose H does not divide sp at every level
    run with H replicated.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from leco_tpu.parallel import mesh as jax_mesh
from leco_tpu.parallel import sharding as jax_sharding
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch.lora import LoRAConv2d
from leco_tpu_torch.models import unet as U
from leco_tpu_torch.models.convert import _module_name
from leco_tpu_torch.models.unet import (
    UNet2DConditionModel,
    sd15_config,
    sd21_config,
    sdxl_config,
    tiny_unet_config,
)
from leco_tpu_torch.parallel import context, distributed, sharding
from leco_tpu_torch.parallel import testing as ptesting
from leco_tpu_torch.parallel import mesh as port_mesh
from leco_tpu_torch.testing import tiny_xl_unet_config
from tests.test_torch_port_unet import port_to_flax

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _port_state(config) -> dict:
    unet = UNet2DConditionModel(config)
    return {k: v.detach().numpy() for k, v in unet.state_dict().items()}


@pytest.mark.parametrize("config", [tiny_unet_config(), tiny_xl_unet_config()],
                         ids=["sd", "xl"])
@pytest.mark.parametrize("tp", [2, 3, 4, 8])
def test_tp_rule_table_is_the_jax_rule(config, tp, devices):
    state = _port_state(config)
    base = port_to_flax({k: np.zeros_like(v) for k, v in state.items()})
    mesh = jax_sharding.make_mesh_2d(devices[: (len(devices) // tp) * tp], tp=tp)
    sharded = flatten_dict(jax_sharding.shard_unet_params(
        jax.tree.map(jnp.asarray, base), mesh))
    shards = 0
    for path, leaf in sharded.items():
        name = f"{_module_name(path[:-1])}.{_LEAF[path[-1]]}"
        spec = tuple(leaf.sharding.spec) + (None,) * leaf.ndim
        flax_dim = next((d for d in range(leaf.ndim) if spec[d] == jax_sharding.TP_AXIS), None)
        # a flax kernel is (in, out), a torch weight (out, in)
        want = None if flax_dim is None else (
            1 - flax_dim if path[-1] == "kernel" else flax_dim)
        assert sharding.param_spec(name, state[name].shape, tp) == want, (name, spec)
        shards += want is not None
    assert shards > 0 if tp in (2, 4, 8) else shards == 0  # widths 8-32: none divides 3


def test_tp_plan_shards_whole_heads_only():
    """SD2.1 at tp 2: level 0's 5 heads of 64 stay replicated (the JAX rule
    would shard their 320 columns, GSPMD resharding the heads), every
    feed-forward and the other levels' attentions shard; SD1.5's 8 heads
    and SDXL's 10 and 20 shard everywhere."""
    with torch.device("meta"):
        unets = {name: UNet2DConditionModel(cfg()) for name, cfg in
                 (("sd15", sd15_config), ("sd21", sd21_config), ("sdxl", sdxl_config))}
    plans = {name: sharding.tp_plan(unet, 2) for name, unet in unets.items()}
    for name, unet in unets.items():
        attentions = [n for n, m in unet.named_modules() if hasattr(m, "to_q")]
        feeds = [n for n, m in unet.named_modules() if hasattr(m, "net")]
        level0 = {n for n in attentions if n.startswith(("down_blocks.0.", "up_blocks.3."))}
        for n in attentions:
            replicated = name == "sd21" and n in level0
            assert (f"{n}.to_q" in plans[name]) != replicated, (name, n)
        assert all(f"{n}.net.0.proj" in plans[name] for n in feeds), name
    assert len(plans["sd15"]) == 16 * 10 and len(plans["sdxl"]) == 70 * 10


def test_geglu_share_takes_matching_value_and_gate_columns():
    idx = sharding.local_index("ff.net.0.proj", sharding.COLUMN, 8, 2, 1)
    assert idx.tolist() == [2, 3, 6, 7]
    assert sharding.local_index("attn1.to_q", sharding.COLUMN, 8, 2, 1).tolist() == [4, 5, 6, 7]


def _mesh(dp: int, sp: int, tp: int = 1):
    """A mesh of one process that answers for `dp` x `sp` x `tp` ranks: this
    rank is at index 0 of each axis, and every axis's group is None, so the
    collectives are the identity (a layer's kernel route shows on one
    process)."""
    sizes = {port_mesh.DP_AXIS: dp, port_mesh.SP_AXIS: sp, port_mesh.TP_AXIS: tp}
    return types.SimpleNamespace(axis_size=lambda name: sizes.get(name, 1),
                                 axis_index=lambda name: 0, group=lambda name: None)


def _in_attentions(layer):
    holder = torch.nn.Module()
    holder.attentions = torch.nn.ModuleList([layer])
    return holder


# knob -> (the layer it routes, its input at H 8 (4 rows a rank under sp 2),
# the plain versions it must call under dp or tp, and under sp)
KNOB_LAYERS = {
    "LECO_CONV_BACKEND": (lambda: LoRAConv2d(8, 8, 3, padding=1), (1, 8, 8, 8),
                          {"conv3x3_gemm_plain"}, {"conv3x3_rows_plain"}),
    "LECO_RESNET_FUSED": (lambda: U.ResnetBlock2D(8, 8, 16, 4), (1, 8, 8, 8),
                          {"gnconv3x3_plain"}, {"gnconv3x3_rows_plain"}),
    "LECO_TPU_FUSED_GN": (lambda: U.GroupNorm(4, 8, 1e-5, silu=True), (1, 8, 8, 8),
                          {"group_norm_silu_plain"},
                          {"group_norm_stats_plain", "group_norm_apply_plain"}),
    "LECO_GEGLU": (lambda: _in_attentions(U.BasicTransformerBlock(8, 2, 8, False, "xla")),
                   (1, 64, 8), {"geglu_gemm_plain"}, {"geglu_gemm_plain"}),
    "LECO_FLASH_PACKED": (lambda: _in_attentions(U.Attention(8, 2, backend="flash")),
                          (1, 256, 8), {"attn_fwd_packed_plain"}, {"attn_fwd_packed_plain"}),
}
KNOB_VALUES = {"LECO_FLASH_PACKED": "1", "LECO_RESNET_FUSED": "1", "LECO_TPU_FUSED_GN": "1",
               "LECO_GEGLU": "fused", "LECO_CONV_BACKEND": "gemm"}


@pytest.mark.parametrize("knob,value", sorted(KNOB_VALUES.items()))
@pytest.mark.parametrize("dp,sp,tp", [(2, 1, 1), (1, 2, 1), (1, 1, 2)])
def test_fused_knobs_run_under_every_mesh(knob, value, dp, sp, tp, monkeypatch):
    """With every knob set, the context accepts each mesh, and the knob's
    layer takes its kernel route on this rank's share: under sp the row
    windows and the split GroupNorm (the gates on the global H: 4 rows a
    rank of an 8-row image), under tp the GEGLU and packed kernels on the
    sharded Linears, under dp the unsharded kernels (the conv gates'
    128-channel floors lowered to the tiny layers' 8)."""
    for k, v in KNOB_VALUES.items():
        monkeypatch.setenv(k, v)
    ctx = context.ParallelContext(_mesh(dp, sp, tp), levels=2)
    make, shape, unsharded, split = KNOB_LAYERS[knob]
    layer = make()
    x = torch.randn(shape)
    if sp > 1:  # this rank's rows (tokens: whole rows)
        dim = 2 if x.ndim == 4 else 1
        x = x.narrow(dim, 0, x.shape[dim] // sp)
    if tp > 1:  # the transformer layers cut to their tp shares; convs and norms replicated
        plan = sharding.shard_unet(layer, ctx.mesh)
        assert bool(plan) == hasattr(layer, "attentions"), knob
    context.attach(layer, ctx)
    ctx.spatial = sp > 1
    module = layer.attentions[0] if hasattr(layer, "attentions") else layer
    args = (torch.randn(1, 16),) if knob == "LECO_RESNET_FUSED" else ()
    if knob == "LECO_GEGLU":
        args = (torch.randn(1, 77, 8),)
    with ptesting.open_gates(), ptesting.counting_kernels() as calls:
        module(x, *args)
    called = {k for k, v in calls.items() if v and not k.startswith("launches_")}
    assert called == (split if sp > 1 else unsharded), (knob, called)


@pytest.mark.parametrize("levels,h,spatial", [(2, 16, True), (2, 18, False), (4, 64, True),
                                              (4, 72, False)])
def test_a_call_shards_h_only_where_every_level_divides_sp(levels, h, spatial):
    """The port's rule for an indivisible level: the whole call keeps H
    replicated, where `constrain_internal` alone would shard it (at sp 2,
    the tiny UNet's H 18 has a level of 9 rows; SD's 4 levels at a 576 px
    bucket: 72 / 36 / 18 / 9)."""
    plan = context.ParallelContext(_mesh(1, 2), levels=levels).plan((1, 4, h, 8))
    assert plan == context.CallPlan(batch=False, spatial=spatial)


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2), (4, 1)])
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_internal_plan_and_shardable_batch_are_the_jax_rules(batch, dp, sp, devices):
    jmesh = jax_mesh.get_mesh_dp_sp(devices[: dp * sp], sp=sp)
    mesh = _mesh(dp, sp)
    assert port_mesh.shardable_batch(batch, mesh) == jax_mesh.shardable_batch(batch, jmesh)
    # the latents, the CFG 2B, the 3B references; H 16, and 9 (divides no sp)
    for n in (batch, 2 * batch, 3 * batch):
        for h in (16, 9):
            x = jax_mesh.constrain_internal(jnp.zeros((n, h, 8, 4)), jmesh)
            spec = tuple(x.sharding.spec) if hasattr(x.sharding, "spec") else ()
            spec += (None,) * (4 - len(spec))
            want = (spec[0], None, spec[1], None)  # NHWC -> NCHW
            assert port_mesh.internal_plan((n, 4, h, 8), mesh) == want, (n, h)


@pytest.mark.parametrize("n,inner", [(2, 1), (2, 2), (4, 2), (8, 2), (8, 4), (6, 3)])
def test_rank_grid_is_the_jax_device_order(n, inner, devices):
    grid = port_mesh.rank_grid(n, inner)
    for jmesh in (jax_sharding.make_mesh_2d(devices[:n], tp=inner),
                  jax_mesh.get_mesh_dp_sp(devices[:n], sp=inner)):
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        np.testing.assert_array_equal(grid, ids - ids.min())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sp_auto_is_half_the_processes(n):
    """`spatial_parallel: 0` gives sp = max(1, n // 2) (train_lora.py:98-99)."""
    assert port_mesh.mesh_axes(True, 1, 0, n) == ("sp", max(1, n // 2))


def test_cli_mesh_choices():
    """As the JAX CLIs choose (train_lora.py:90-107, train_lora_xl.py:87-89):
    sp and tp exclusive, no mesh without data_parallel, tp or sp, and SDXL
    without sp."""
    with pytest.raises(ValueError, match="exclusive"):
        port_mesh.mesh_axes(True, 2, 2, 4)
    assert port_mesh.mesh_axes(False, 1, 1, 4) is None
    assert port_mesh.mesh_axes(True, 1, 1, 4) == ("tp", 1)
    assert port_mesh.mesh_axes(False, 2, 1, 4) == ("tp", 2)
    assert port_mesh.mesh_axes(False, 1, 2, 4) == ("sp", 2)
    assert port_mesh.mesh_axes(True, 2, 1, 4, xl=True) == ("tp", 2)
    with pytest.raises(ValueError, match="SDXL"):
        port_mesh.mesh_axes(True, 1, 2, 4, xl=True)
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.mesh_axes(True, 4, 1, 2)


@pytest.mark.parametrize("seed", [None, 0, 1234])
def test_shared_seed_passes_through_at_world_size_one(seed):
    assert distributed.world_size() == 1
    assert distributed.shared_seed(seed) == jax_trainer._multihost_shared_seed(seed) == seed


def test_no_launcher_environment_starts_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not distributed.initialized()
