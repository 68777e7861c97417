"""The port's train step and train() against the JAX package's.

One step on `leco_tpu.testing.make_random_bundle()` (the tiny fp32 UNet,
attn_backend "xla") and the port's step on the same weights, the same prompt
embeddings and the same latents: the JAX step's own draw from
`jax.random.split(key)`, handed to the port in NCHW (DDIM needs no other
noise). At 128 px level 0 has 256 tokens, so the port's flash route runs,
its backward included (the kernels' plain versions on the CPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from leco_tpu import lora as jax_lora
from leco_tpu.models.convert import _fold_path
from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import make_random_bundle as jax_random_bundle
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import trainer as jax_trainer
from leco_tpu.utils.debug import check_frozen_params, check_trainable_params
from leco_tpu_torch import lora
from leco_tpu_torch.config import RootConfig
from leco_tpu_torch.models.convert import flax_unet_to_torch
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptEmbedsPair, PromptSettings
from leco_tpu_torch.testing import make_random_bundle
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer
from leco_tpu_torch.utils import debug as port_debug

LR = 1e-4  # the van-gogh recipe (examples/config.yaml)
MAX_STEPS = 4
TIMESTEPS_TO = 2
RES = 128
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0,
              resolution=RES, batch_size=1)


def _port_unet_from(jax_bundle) -> UNet2DConditionModel:
    cfg = jax_bundle.unet.config
    port = UNet2DConditionModel(
        UNetConfig(**{f: getattr(cfg, f) for f in UNetConfig.__dataclass_fields__}),
        attn_backend="flash",
    )
    spec = jax_bundle.spec
    lora.apply_lora_spec(
        port, lora.LoRASpec(spec.rank, spec.alpha, spec.network_type, spec.train_method),
        torch.Generator(),
    )
    params = jax_lora.merge_params(jax_bundle.base_params, jax_bundle.lora_params)
    port.load_state_dict(flax_unet_to_torch(jax.tree.map(np.asarray, params)))
    port.requires_grad_(False)
    for p in lora.lora_parameters(port).values():
        p.requires_grad_(True)
    return port


def _port_name(path: tuple) -> str:
    """flax LoRA leaf path -> the port's parameter name."""
    from leco_tpu_torch.models.convert import _module_name

    return f"{_module_name(path[:-1])}.{path[-1]}"


@pytest.fixture(scope="module")
def one_step():
    jb = jax_random_bundle()
    # the JAX side: one jitted step
    optimizer = jax_optim.get_optimizer(
        "adamw", jax_optim.get_lr_schedule("constant", LR, 10)
    )
    settings = JaxPromptSettings(**PROMPT)
    (pair,) = jax_trainer.encode_prompt_pairs([settings], jb.encode_fn)
    pack = jax_trainer.build_pack(pair, False, RES, RES)
    key = jax.random.PRNGKey(7)
    k_latents, _ = jax.random.split(key)
    latents = np.asarray(jax_diff.get_random_noise(k_latents, 1, RES, RES))

    port = _port_unet_from(jb)  # before the step donates the JAX buffers
    summaries = {
        "jax": (check_trainable_params(jb.lora_params), check_frozen_params(jb.base_params)),
        "port": (port_debug.check_trainable_params(port), port_debug.check_frozen_params(port)),
    }
    lora_before = {_port_name(k): np.asarray(v)
                   for k, v in flatten_dict(jb.lora_params).items()}

    opt_state = optimizer.init(jb.lora_params)
    step = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)
    lora_j, opt_state, loss_j = step(
        jb.base_params, jb.lora_params, opt_state, key, pack,
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=RES, width=RES, shard_batch=False,
    )

    # the port's side: the same weights, embeddings and latents
    bundle = trainer.ModelBundle(
        unet=port, scheduler=NoiseScheduler("ddim"),
        spec=lora.LoRASpec(rank=4, alpha=1.0), device=torch.device("cpu"),
    )
    port_pair = PromptEmbedsPair(
        *(torch.tensor(np.asarray(e)) for e in
          (pair.target, pair.positive, pair.unconditional, pair.neutral)),
        PromptSettings.from_dict(PROMPT),
    )
    params = bundle.lora_params
    opt = get_optimizer("adamw", list(params.values()), LR)
    step_t = trainer.make_train_step(bundle, opt, MAX_STEPS)
    calls = {"attn_fwd_plain": 0, "attn_bwd_dq_plain": 0, "attn_bwd_dkv_plain": 0}
    real = {name: getattr(fa, name) for name in calls}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn

    try:
        for name in calls:
            setattr(fa, name, counted(name))
        loss_t = step_t(
            trainer.build_pack(port_pair), port_pair.guidance_scale,
            port_pair.erase_sign, TIMESTEPS_TO, height=RES, width=RES,
            latents=torch.tensor(latents.transpose(0, 3, 1, 2)),
        )
    finally:
        for name, fn in real.items():
            setattr(fa, name, fn)
    mu = flatten_dict(opt_state[0].mu)
    return dict(
        loss=(float(loss_t), float(loss_j)),
        grads={_port_name(k): (opt.state[params[_port_name(k)]]["exp_avg"] / 0.1,
                               np.asarray(v) / 0.1) for k, v in mu.items()},
        lora={_port_name(k): (params[_port_name(k)].detach(), np.asarray(v))
              for k, v in flatten_dict(lora_j).items()},
        lora_before=lora_before,
        flash_calls=calls,
        summaries=summaries,
    )


def _flax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """A port LoRA tensor in the JAX package's layout."""
    v = t.numpy()
    if name.endswith("lora_down"):
        return v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
    return v.T if v.ndim == 2 else v[:, :, 0, 0].T


def test_debug_summaries_match_jax(one_step):
    (jt, jf), (pt, pf) = one_step["summaries"]["jax"], one_step["summaries"]["port"]
    for key in ("trainable tensors", "trainable params", "lora layers", "dtypes"):
        assert pt[key] == jt[key], key
    assert pf["frozen params"] == jf["frozen params"]


def test_step_takes_the_flash_route(one_step):
    """Level 0 (256 tokens) has 3 self-attentions in the tiny UNet; the step
    runs TIMESTEPS_TO + 2 forwards and differentiates the last one."""
    assert one_step["flash_calls"] == {
        "attn_fwd_plain": 3 * (TIMESTEPS_TO + 2),
        "attn_bwd_dq_plain": 3,
        "attn_bwd_dkv_plain": 3,
    }


def test_loss_matches(one_step):
    got, want = one_step["loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lora_gradients_match(one_step):
    """dL/dLoRA, read back from AdamW's first moment (mu = 0.1 * g after one
    step) on both sides. fp32; the two sides sum in other orders through
    the whole UNet, so the bound is relative to each tensor's size."""
    nonzero = 0
    for name, (got, want) in one_step["grads"].items():
        got = _flax_layout(name, got)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, err_msg=name)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > 0


def test_updated_lora_matches(one_step):
    changed = 0
    for name, (got, want) in one_step["lora"].items():
        got = _flax_layout(name, got)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        changed += not np.array_equal(want, one_step["lora_before"][name])
    assert changed > 0


def test_train_writes_metrics_and_the_jax_export_layout(tmp_path):
    """Two iterations of the port's train() on the CPU; the .safetensors it
    writes holds what the JAX package's export_lora_state writes for the
    same weights: keys, shapes and values."""
    from safetensors.numpy import load_file

    bundle = make_random_bundle(attn_backend="flash")
    config = RootConfig.from_dict({
        "prompts_file": "unused.yaml",
        "pretrained_model": {"name_or_path": "random://tiny"},
        "train": {"iterations": 2, "max_denoising_steps": 3, "lr": LR,
                  "seed": 0, "precision": "float32"},
        "save": {"name": "tiny", "path": str(tmp_path), "per_steps": 2},
    })
    result = trainer.train(config, [PromptSettings.from_dict(PROMPT)], bundle)
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))

    records = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    rng = np.random.default_rng(0)  # the host stream: (pair, timesteps_to) draws
    for r in records:
        assert int(rng.integers(0, 1)) == 0
        assert r["timesteps_to"] == int(rng.integers(1, 3))
        assert r["resolution"] == [RES, RES] and r["lr"] == LR

    tree = {_fold_path(k.rsplit(".", 1)[0]) + (k.rsplit(".", 1)[1],): _flax_layout(k, v)
            for k, v in result["lora"].items()}
    from flax.traverse_util import unflatten_dict

    want = jax_lora.export_lora_state(unflatten_dict(tree), jax_lora.LoRASpec(4, 1.0))
    got = load_file(str(tmp_path / "tiny_last.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
