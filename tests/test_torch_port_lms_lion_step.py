"""One train step of this slice's options against the JAX package's:
`noise_scheduler: lms` (deterministic, and the one that exercises
`init_noise_sigma`, `input_scales` and float timesteps), Lion at step k > 0
of a cosine schedule, and `checkpoint_unet` (the JAX UNet built with
`remat=True`).

The fixture pattern of `tests/test_torch_port_train_step.py`: the tiny fp32
UNet of `leco_tpu.testing.make_random_bundle()`, its weights in the port's
UNet, one prompt pair's embeddings and the JAX step's own latent draw
(times LMS's init_noise_sigma, as `get_initial_latents` scales it) handed to
the port in NCHW. The port runs the step with `checkpoint_unet` off and on;
the two are bit-equal on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import make_random_bundle as jax_random_bundle
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch import lora
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptEmbedsPair, PromptSettings
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_lr_schedule, get_optimizer
from tests.test_torch_port_train_step import _flax_layout, _port_name, _port_unet_from

LR, ITERATIONS, K = 1e-4, 10, 3  # Lion at step 3 of a 10-iteration cosine
MAX_STEPS, TIMESTEPS_TO, RES = 4, 2, 128
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0,
              resolution=RES, batch_size=1)
B2 = 0.99  # Lion's mu after one step from zero is (1 - b2) * g
# the tolerances of tests/test_torch_port_train_step.py
RTOL_LOSS, RTOL_GRAD, ATOL_LORA = 1e-4, 1e-4, 1e-6


def _port_step(jb, pair, latents, checkpoint_unet: bool):
    port = _port_unet_from(jb)
    port.checkpoint_unet = checkpoint_unet
    bundle = trainer.ModelBundle(
        unet=port, scheduler=NoiseScheduler("lms"), spec=lora.LoRASpec(rank=4, alpha=1.0),
        device=torch.device("cpu"))
    port_pair = PromptEmbedsPair(
        *(torch.tensor(np.asarray(e)) for e in
          (pair.target, pair.positive, pair.unconditional, pair.neutral)),
        PromptSettings.from_dict(PROMPT))
    params = bundle.lora_params
    opt = get_optimizer("lion", list(params.values()), LR)
    opt.param_groups[0]["lr"] = get_lr_schedule("cosine", LR, ITERATIONS)(K)
    step = trainer.make_train_step(bundle, opt, MAX_STEPS)
    fa.reset_launch_counts()
    calls = {"fwd": 0}
    real = fa.attn_fwd_plain

    def counted(*args):
        calls["fwd"] += 1
        return real(*args)

    fa.attn_fwd_plain = counted
    try:
        loss = step(trainer.build_pack(port_pair), port_pair.guidance_scale,
                    port_pair.erase_sign, TIMESTEPS_TO, height=RES, width=RES,
                    latents=torch.tensor(latents.transpose(0, 3, 1, 2)))
    finally:
        fa.attn_fwd_plain = real
    return dict(
        loss=float(loss),
        grads={k: opt.state[p]["mu"] / (1 - B2) for k, p in params.items()},
        lora={k: p.detach().clone() for k, p in params.items()},
        forwards=calls["fwd"],
    )


@pytest.fixture(scope="module")
def lms_lion_step():
    jax.config.update("jax_platforms", "cpu")
    jb = jax_random_bundle(scheduler_kind="lms", remat=True)
    optimizer = jax_optim.get_optimizer(
        "lion", jax_optim.get_lr_schedule("cosine", LR, ITERATIONS, LR / 100))
    (pair,) = jax_trainer.encode_prompt_pairs([JaxPromptSettings(**PROMPT)], jb.encode_fn)
    pack = jax_trainer.build_pack(pair, False, RES, RES)
    key = jax.random.PRNGKey(5)
    k_latents, _ = jax.random.split(key)
    state_n = jb.scheduler.set_timesteps(MAX_STEPS)
    latents = np.asarray(jax_diff.get_initial_latents(k_latents, state_n, 1, RES, RES))
    assert float(state_n.init_noise_sigma) > 1.0  # LMS scales the first latents

    port = {ckpt: _port_step(jb, pair, latents, ckpt) for ckpt in (False, True)}
    lora_before = {_port_name(k): np.asarray(v) for k, v in flatten_dict(jb.lora_params).items()}

    opt_state = optimizer.init(jb.lora_params)
    # the schedule's count at K: every count in the chain's states
    def counted(s):
        return "count" in getattr(s, "_fields", ())

    opt_state = jax.tree.map(
        lambda s: s._replace(count=jnp.asarray(K, jnp.int32)) if counted(s) else s,
        opt_state, is_leaf=counted)
    step = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)
    lora_j, opt_state, loss_j = step(
        jb.base_params, jb.lora_params, opt_state, key, pack,
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=RES, width=RES, shard_batch=False)
    mu = flatten_dict(opt_state[0].mu)
    return dict(
        port=port, loss=float(loss_j), lora_before=lora_before,
        grads={_port_name(k): np.asarray(v) / (1 - B2) for k, v in mu.items()},
        lora={_port_name(k): np.asarray(v) for k, v in flatten_dict(lora_j).items()},
    )


def test_checkpoint_unet_is_bit_equal_on_the_cpu(lms_lion_step):
    off, on = lms_lion_step["port"][False], lms_lion_step["port"][True]
    assert on["loss"] == off["loss"]
    for k in off["grads"]:
        assert torch.equal(on["grads"][k], off["grads"][k]), k
        assert torch.equal(on["lora"][k], off["lora"][k]), k
    # the target forward runs once more, in the backward: 3 level-0
    # self-attentions a forward at 128 px
    assert off["forwards"] == 3 * (TIMESTEPS_TO + 2)
    assert on["forwards"] == off["forwards"] + 3


@pytest.mark.parametrize("checkpoint_unet", [False, True])
def test_loss_matches_jax(lms_lion_step, checkpoint_unet):
    got = lms_lion_step["port"][checkpoint_unet]["loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, lms_lion_step["loss"], rtol=RTOL_LOSS)


@pytest.mark.parametrize("checkpoint_unet", [False, True])
def test_lora_gradients_match_jax(lms_lion_step, checkpoint_unet):
    nonzero = 0
    for name, want in lms_lion_step["grads"].items():
        got = _flax_layout(name, lms_lion_step["port"][checkpoint_unet]["grads"][name])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, atol=RTOL_GRAD * scale, err_msg=name)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > 0


@pytest.mark.parametrize("checkpoint_unet", [False, True])
def test_updated_lora_matches_jax(lms_lion_step, checkpoint_unet):
    """Lion moves each weight by lr_k * sign(g): within ATOL_LORA wherever
    JAX's gradient is further from zero than the gradient tolerance (there
    the sign is determined); a gradient within it may take either sign, and
    its weight moves by 2 lr_k at most."""
    lr_k = get_lr_schedule("cosine", LR, ITERATIONS)(K)
    assert lr_k < LR
    changed = undetermined = 0
    for name, want in lms_lion_step["lora"].items():
        got = _flax_layout(name, lms_lion_step["port"][checkpoint_unet]["lora"][name])
        g = lms_lion_step["grads"][name]
        determined = np.abs(g) > RTOL_GRAD * max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(got[determined], want[determined], atol=ATOL_LORA,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2 * lr_k * (1 + 1e-3), name
        undetermined += int((~determined & (np.abs(g) > 0)).sum())
        changed += not np.array_equal(want, lms_lion_step["lora_before"][name])
    assert changed > 0
    assert undetermined < 0.01 * sum(v.size for v in lms_lion_step["lora"].values())
