"""One v-prediction train step (the default recipe's `v_pred: true`) of the
port against the JAX package's, as test_torch_port_train_step.py does for
epsilon: the tiny fp32 UNet on shared weights, the same embeddings and
latents. The DDIM inner loop is where v-prediction enters. The port's step
runs twice: on the 3-d flash route and under LECO_FLASH_PACKED=1, where
level 0 (256 tokens at 128 px) takes the packed route, its plain fp32
backward included."""

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
from leco_tpu_torch.train.optim import get_optimizer
from tests.test_torch_port_train_step import _flax_layout, _port_name, _port_unet_from

LR, MAX_STEPS, TIMESTEPS_TO, RES = 1e-4, 4, 3, 128
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0,
              resolution=RES, batch_size=1)


@pytest.fixture(scope="module")
def jax_step():
    jb = jax_random_bundle(prediction_type="v_prediction", seed=1)
    optimizer = jax_optim.get_optimizer("adamw", jax_optim.get_lr_schedule("constant", LR, 10))
    (pair,) = jax_trainer.encode_prompt_pairs([JaxPromptSettings(**PROMPT)], jb.encode_fn)
    pack = jax_trainer.build_pack(pair, False, RES, RES)
    key = jax.random.PRNGKey(11)
    latents = np.asarray(jax_diff.get_random_noise(jax.random.split(key)[0], 1, RES, RES))
    embeds = [np.asarray(e) for e in (pair.target, pair.positive, pair.unconditional,
                                      pair.neutral)]
    ports = {route: _port_unet_from(jb) for route in ("3d", "packed")}
    lora_j, _, loss_j = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)(
        jb.base_params, jb.lora_params, optimizer.init(jb.lora_params), key, pack,
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=RES, width=RES, shard_batch=False)
    return dict(loss=float(loss_j), embeds=embeds, latents=latents, ports=ports,
                lora={_port_name(k): np.asarray(v) for k, v in flatten_dict(lora_j).items()})


@pytest.mark.parametrize("route", ["3d", "packed"])
def test_vpred_step_matches_jax(jax_step, route, monkeypatch):
    if route == "packed":
        monkeypatch.setenv("LECO_FLASH_PACKED", "1")
    else:
        monkeypatch.delenv("LECO_FLASH_PACKED", raising=False)
    calls = []
    real = fa.attn_fwd_packed_plain
    monkeypatch.setattr(fa, "attn_fwd_packed_plain", lambda *a: calls.append(1) or real(*a))
    port = jax_step["ports"][route]
    bundle = trainer.ModelBundle(unet=port, scheduler=NoiseScheduler("ddim", "v_prediction"),
                                 spec=lora.LoRASpec(rank=4, alpha=1.0),
                                 device=torch.device("cpu"))
    pair = PromptEmbedsPair(*map(torch.tensor, jax_step["embeds"]),
                            PromptSettings.from_dict(PROMPT))
    params = bundle.lora_params
    step = trainer.make_train_step(bundle, get_optimizer("adamw", list(params.values()), LR),
                                   MAX_STEPS)
    loss = step(trainer.build_pack(pair), pair.guidance_scale, pair.erase_sign, TIMESTEPS_TO,
                height=RES, width=RES,
                latents=torch.tensor(jax_step["latents"].transpose(0, 3, 1, 2)))
    # the tiny UNet's level 0 has 3 self-attentions per forward
    assert len(calls) == (3 * (TIMESTEPS_TO + 2) if route == "packed" else 0)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=1e-4)
    for name, want in jax_step["lora"].items():
        np.testing.assert_allclose(_flax_layout(name, params[name].detach()), want, atol=1e-6,
                                   err_msg=name)
