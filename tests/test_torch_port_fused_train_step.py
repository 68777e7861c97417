"""One train step of the JAX package's fused-kernel configuration, the port's
against the JAX package's: the setup of tests/test_torch_port_train_step.py
(the tiny fp32 UNet of `leco_tpu.testing.make_random_bundle`, the JAX step's
own latents handed to the port) with the four knobs on and the shape gates
forced open on both sides, as tests/test_torch_port_fused_path.py sets them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import make_random_bundle as jax_random_bundle
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch import lora
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptEmbedsPair, PromptSettings
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer
from test_torch_port_fused_path import _count_plain_calls, knobs  # noqa: F401
from test_torch_port_train_step import _flax_layout, _port_name, _port_unet_from

LR, MAX_STEPS, TIMESTEPS_TO, RES = 1e-4, 4, 2, 128
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0,
              resolution=RES, batch_size=1)


@pytest.fixture
def one_step(knobs, monkeypatch):
    jb = jax_random_bundle()
    optimizer = jax_optim.get_optimizer("adamw", jax_optim.get_lr_schedule("constant", LR, 10))
    (pair,) = jax_trainer.encode_prompt_pairs([JaxPromptSettings(**PROMPT)], jb.encode_fn)
    pack = jax_trainer.build_pack(pair, False, RES, RES)
    key = jax.random.PRNGKey(7)
    latents = np.asarray(jax_diff.get_random_noise(jax.random.split(key)[0], 1, RES, RES))
    port = _port_unet_from(jb)  # before the step donates the JAX buffers
    opt_state = optimizer.init(jb.lora_params)
    step = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)
    with pltpu.force_tpu_interpret_mode():
        lora_j, _, loss_j = step(
            jb.base_params, jb.lora_params, opt_state, key, pack,
            jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
            jnp.int32(TIMESTEPS_TO), height=RES, width=RES, shard_batch=False)

    bundle = trainer.ModelBundle(unet=port, scheduler=NoiseScheduler("ddim"),
                                 spec=lora.LoRASpec(rank=4, alpha=1.0),
                                 device=torch.device("cpu"))
    port_pair = PromptEmbedsPair(
        *(torch.tensor(np.asarray(e)) for e in
          (pair.target, pair.positive, pair.unconditional, pair.neutral)),
        PromptSettings.from_dict(PROMPT))
    params = bundle.lora_params
    step_t = trainer.make_train_step(bundle, get_optimizer("adamw", list(params.values()), LR),
                                     MAX_STEPS)
    calls = _count_plain_calls(monkeypatch)
    loss_t = step_t(trainer.build_pack(port_pair), port_pair.guidance_scale,
                    port_pair.erase_sign, TIMESTEPS_TO, height=RES, width=RES,
                    latents=torch.tensor(latents.transpose(0, 3, 1, 2)))
    return dict(loss=(float(loss_t), float(loss_j)), calls=calls,
                lora={_port_name(k): (params[_port_name(k)].detach(), np.asarray(v))
                      for k, v in flatten_dict(lora_j).items()})


def test_fused_train_step_matches_jax(one_step):
    """TIMESTEPS_TO + 2 forwards, each through the kernels' plain versions as
    counted per forward above, plus the backward's conv dx for the one
    kernel conv whose input needs a gradient, conv_out (conv_in's input is
    the latents; the upsampler runs phase convolutions)."""
    forwards = TIMESTEPS_TO + 2
    assert one_step["calls"] == {"conv3x3_gemm_plain": 2 * forwards + 1,
                                 "gnconv3x3_plain": 16 * forwards,
                                 "group_norm_silu_plain": 5 * forwards,
                                 "geglu_gemm_plain": 4 * forwards}
    got, want = one_step["loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    changed = 0
    for name, (got_w, want_w) in one_step["lora"].items():
        np.testing.assert_allclose(_flax_layout(name, got_w), want_w, atol=1e-6, err_msg=name)
        changed += 1
    assert changed > 0
