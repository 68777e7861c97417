"""A narrow SDXL-shaped UNet against the JAX package's, with shared weights:
3 levels (the first without attention), the 10-deep level-3 stack (and the
mid block's), every head 8 wide, linear projections, and the text_time added
embedding (`testing.tiny_xl_unet_config(10)`). Every parameter, the norms'
affines and the LoRA leaves included, is perturbed by 0.05 N(0, 1) off its
initial value. The port in fp32 is held to JAX in fp32, and both to the
port's own float64 forward (plain attention, float64 statistics and
sinusoids), which the JAX package's real-width test could not reach at this
perturbation (tests/test_torch_unet_fullgraph.py drops to 0.01). A 32x32
latent gives level 1 256 tokens, so the port's fp32 forward takes the flash
route (the kernels' plain versions on the CPU)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu import lora as jax_lora
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu.models.unet import sdxl_config as jax_sdxl_config
from leco_tpu_torch import lora
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig, sdxl_config
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops import group_norm as gn
from leco_tpu_torch.testing import init_unet_, tiny_xl_unet_config, xl_pooled_dim
from tests.test_torch_port_unet import port_to_flax

SPEC = dict(rank=4, alpha=1.0)
PERTURB = 0.05
# fp32 against fp32, and each fp32 forward against the float64 one:
# relative to the reference output's largest magnitude
RTOL_FP32, RTOL_F64 = 1e-4, 1e-4
LATENT = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_config(cfg: UNetConfig) -> JaxUNetConfig:
    return JaxUNetConfig(**{f: getattr(cfg, f) for f in UNetConfig.__dataclass_fields__})


def xl_inputs(rng: np.random.Generator, cfg: UNetConfig, batch: int = 2, latent: int = LATENT):
    """NHWC sample, timesteps, context and the added conditioning (numpy)."""
    sample = rng.standard_normal((batch, latent, latent, 4)).astype(np.float32)
    t = np.array([501.0, 33.0][:batch], np.float32)
    ctx = rng.standard_normal((batch, 77, cfg.cross_attention_dim)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((batch, xl_pooled_dim(cfg))).astype(np.float32),
             "time_ids": np.tile(np.array([[1024, 768, 64, 0, 1024, 768]], np.float32),
                                 (batch, 1))}
    return sample, t, ctx, added


def port_forward(port, inputs, dtype=torch.float32) -> np.ndarray:
    sample, t, ctx, added = inputs
    with torch.no_grad():
        out = port(torch.from_numpy(sample.transpose(0, 3, 1, 2)).to(dtype),
                   torch.from_numpy(t).to(dtype), torch.from_numpy(ctx).to(dtype),
                   {k: torch.from_numpy(v).to(dtype) for k, v in added.items()})
    return out.double().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def shared():
    cfg = tiny_xl_unet_config(depth=10)
    rng = np.random.default_rng(0)
    port = UNet2DConditionModel(cfg, attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(port, gen, torch.float32)
    lora.apply_lora_spec(port, lora.LoRASpec(**SPEC), gen)
    state = {k: v.numpy() + PERTURB * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in port.state_dict().items()}
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = port_to_flax(state)
    spec = jax_lora.LoRASpec(**SPEC)
    base, lora_tree = jax_lora.split_lora_params(params)
    trees = {"on": params, "off": base,
             "folded": jax_lora.fold_lora_params(base, lora_tree, spec)}
    oracle = UNet2DConditionModel(cfg, dtype=torch.float64, attn_backend="xla")
    lora.apply_lora_spec(oracle, lora.LoRASpec(**SPEC), torch.Generator().manual_seed(0))
    oracle.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    oracle.double()
    unet = JaxUNet(config=jax_config(cfg), lora_spec=spec)
    # one jitted apply: "off" and "folded" share a tree structure, one compile
    return dict(cfg=cfg, port=port, oracle=oracle, trees=trees, apply=jax.jit(unet.apply),
                inputs=xl_inputs(rng, cfg), jax_out={})


def _jax_forward(models, mode) -> np.ndarray:
    if mode not in models["jax_out"]:
        sample, t, ctx, added = models["inputs"]
        models["jax_out"][mode] = np.asarray(models["apply"](
            {"params": jax.tree.map(jnp.asarray, models["trees"][mode])},
            jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
            {k: jnp.asarray(v) for k, v in added.items()})).astype(np.float64)
    return models["jax_out"][mode]


def _mode(port, mode):
    return lora.folded_lora(port) if mode == "folded" else lora.lora_mode(port, mode)


def test_sdxl_config_matches_jax():
    assert UNetConfig(**{f: getattr(jax_sdxl_config(), f)
                         for f in UNetConfig.__dataclass_fields__}) == sdxl_config()
    cfg = sdxl_config()
    assert {c // h for c, h in zip(cfg.block_out_channels, cfg.heads_per_block)} == {64}
    with torch.device("meta"):
        unet = UNet2DConditionModel(cfg)
    # SDXL base's 2,567,463,684 parameters, the add_embedding's included
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684
    assert tuple(unet.add_embedding.linear_1.weight.shape) == (1280, 2816)
    assert len(unet.mid_block.attentions[0].transformer_blocks) == 10


@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_forward_matches_jax(shared, mode, monkeypatch):
    calls = []
    real = fa.attn_fwd_plain
    monkeypatch.setattr(fa, "attn_fwd_plain", lambda *a: calls.append(a[0].shape) or real(*a))
    with _mode(shared["port"], mode):
        got = port_forward(shared["port"], shared["inputs"])
    want = _jax_forward(shared, mode)
    # level 1 (16 x 16 tokens, 2 heads of 8): 2 x 2 down + 3 x 2 up self-attentions
    assert calls == [(4, 256, 8)] * 10
    assert got.shape == want.shape == (2, LATENT, LATENT, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_FP32 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_port_and_jax_match_the_float64_forward(shared, mode):
    """Both fp32 forwards against the port's float64 forward, the same
    weights (perturbed at 0.05) and inputs."""
    with _mode(shared["oracle"], mode):
        want = port_forward(shared["oracle"], shared["inputs"], torch.float64)
    with _mode(shared["port"], mode):
        got = port_forward(shared["port"], shared["inputs"])
    limit = RTOL_F64 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)
    np.testing.assert_allclose(_jax_forward(shared, mode), want, rtol=0, atol=limit)
    # the oracle is no copy of either: float64 moves the output off fp32's
    assert np.abs(got - want).max() > 0


def test_added_embedding_moves_the_output(shared):
    """The text_time embedding reaches the output: other time_ids, other
    pooled embeddings, another prediction."""
    sample, t, ctx, added = shared["inputs"]
    base = port_forward(shared["port"], shared["inputs"])
    for key in added:
        other = dict(added, **{key: added[key] + 1.0})
        moved = port_forward(shared["port"], (sample, t, ctx, other))
        assert np.abs(moved - base).max() > 1e-3 * np.abs(base).max(), key


def test_knob_route_hands_the_group_norm_nchw(shared, monkeypatch):
    """Under LECO_TPU_FUSED_GN=1 every GroupNorm input is NCHW-contiguous,
    the layout the kernel reads (it refuses others): the linear projection
    hands back a channels_last view, which the transformer's residual sum
    must not pass on to the resnets and norms after it. The sample is NCHW,
    as the trainer's and the sampler's latents are. The same output."""
    sample, t, ctx, added = shared["inputs"]
    inputs = (np.ascontiguousarray(sample.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1),
              t, ctx, added)
    base = port_forward(shared["port"], inputs)
    layouts = []
    real = gn.fused_group_norm

    def spy(x, *args):
        layouts.append(x.is_contiguous())
        return real(x, *args)

    monkeypatch.setattr(gn, "fused_group_norm", spy)
    monkeypatch.setenv("LECO_TPU_FUSED_GN", "1")
    got = port_forward(shared["port"], inputs)
    assert len(layouts) > 0 and all(layouts), layouts
    np.testing.assert_allclose(got, base, rtol=0, atol=RTOL_FP32 * np.abs(base).max())


def test_missing_added_cond_kwargs_raises(shared):
    sample, t, ctx, _ = shared["inputs"]
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        shared["port"](torch.from_numpy(sample.transpose(0, 3, 1, 2)), torch.from_numpy(t),
                       torch.from_numpy(ctx))


def test_wrong_added_width_raises(shared):
    sample, t, ctx, added = shared["inputs"]
    narrow = dict(added, text_embeds=added["text_embeds"][:, :-1])
    with pytest.raises(ValueError, match="added embedding of width"):
        port_forward(shared["port"], (sample, t, ctx, narrow))


def test_checkpoint_unet_gives_the_same_grads(shared):
    """checkpoint_unet recomputes the blocks in the backward; the time and
    added embeddings come into each block from outside: the same loss and
    LoRA grads as without it."""
    port = copy.deepcopy(shared["port"])
    port.requires_grad_(False)
    params = lora.lora_parameters(port)
    for p in params.values():
        p.requires_grad_(True)
    sample, t, ctx, added = xl_inputs(np.random.default_rng(3), shared["cfg"], 1, 16)
    args = (torch.from_numpy(sample.transpose(0, 3, 1, 2)), 501.0, torch.from_numpy(ctx),
            {k: torch.from_numpy(v) for k, v in added.items()})
    grads = []
    for on in (False, True):
        port.checkpoint_unet = on
        loss = port(*args).square().mean()
        grads.append((loss.detach(), torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert any(g.abs().max() > 0 for g in grads[0][1])
