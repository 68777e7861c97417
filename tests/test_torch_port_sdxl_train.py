"""The port's SDXL training against the JAX package's: the micro-conditioning
`get_add_time_ids` (static; dynamic crops with the same numpy draws; the
2816 guard), the XL pack of `build_pack`, one XL train step on the same
weights, embeddings and latents (the port's random tiny XL UNet carried to
a JAX bundle through `port_to_flax`, the JAX package's fake XL encoder on
both sides; depth 1 at level 2, which keeps the JAX step's compile short:
the 10-deep stack is held to JAX in test_torch_port_sdxl_unet.py), and
`train()` with dynamic crops
and dynamic resolution: the same (pair, timesteps_to, resolution, time_ids)
sequence as the JAX `train()`, the same losses when both draw the same
latents, the JAX export's AddNet names; then a resumed run bit-equal to the
uninterrupted one."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from leco_tpu import config as jax_config
from leco_tpu import lora as jax_lora
from leco_tpu.models.convert import _fold_path
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu.ops.schedulers import NoiseScheduler as JaxNoiseScheduler
from leco_tpu.prompts import PromptEmbedsXL as JaxPromptEmbedsXL
from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import _fake_encode_fn as jax_fake_encode_fn
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch import lora
from leco_tpu_torch.config import RootConfig
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptEmbedsPair, PromptEmbedsXL, PromptSettings
from leco_tpu_torch.testing import init_unet_, make_random_bundle, tiny_xl_unet_config
from leco_tpu_torch.train import diffusion as diff
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer
from leco_tpu_torch.models.unet import UNet2DConditionModel
from tests.test_torch_port_train_step import _flax_layout, _port_name
from tests.test_torch_port_unet import port_to_flax

LR = 1e-4
MAX_STEPS = 4
TIMESTEPS_TO = 2
RES = 256  # level 1 of the tiny XL UNet at 16 x 16 = 256 tokens: the flash route
TINY_XL = tiny_xl_unet_config(depth=1)
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0,
              resolution=RES, batch_size=2, dynamic_crops=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_xl_config():
    return JaxUNetConfig(**{f: getattr(TINY_XL, f) for f in TINY_XL.__dataclass_fields__})


def _bundles():
    """A random port UNet (LoRA leaves as `apply_lora_spec` draws them) and
    a JAX bundle on the same weights: -> (port UNet, JAX bundle)."""
    port = UNet2DConditionModel(TINY_XL, attn_backend="flash")
    gen = torch.Generator().manual_seed(0)
    init_unet_(port, gen, torch.float32)
    lora.apply_lora_spec(port, lora.LoRASpec(rank=4, alpha=1.0), gen)
    for p in lora.lora_parameters(port).values():
        p.requires_grad_(True)
    base, lora_tree = jax_lora.split_lora_params(
        port_to_flax({k: v.numpy() for k, v in port.state_dict().items()}))
    spec = jax_lora.LoRASpec(4, 1.0)
    jb = jax_trainer.ModelBundle(
        unet=JaxUNet(config=_jax_xl_config(), lora_spec=spec),
        base_params=jax.tree.map(jnp.asarray, base),
        lora_params=jax.tree.map(jnp.asarray, lora_tree), scheduler=JaxNoiseScheduler("ddim"),
        spec=spec, encode_fn=jax_fake_encode_fn(TINY_XL.cross_attention_dim, True, 8),
        is_xl=True)
    return port, jb


@pytest.fixture(scope="module")
def bundles():
    return _bundles()


def _port_embeds(e) -> PromptEmbedsXL:
    return PromptEmbedsXL(torch.tensor(np.asarray(e.text_embeds)),
                          torch.tensor(np.asarray(e.pooled_embeds)))


# ---------------------------------------------------------------------------
# get_add_time_ids and build_pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1024, 1024), (1024, 768), (512, 832)])
def test_static_time_ids_match_jax(h, w):
    got = diff.get_add_time_ids(h, w)
    np.testing.assert_array_equal(got, jax_diff.get_add_time_ids(h, w))
    assert got.dtype == np.float32 and got.tolist() == [[h, w, 0, 0, h, w]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_crop_time_ids_draw_as_jax(seed):
    """rng.random(), then two rng.integers: the same ids and the generator
    left in the same state."""
    rng_port, rng_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    for h, w in ((1024, 1024), (768, 1024), (64, 64)):
        got = diff.get_add_time_ids(h, w, dynamic_crops=True, rng=rng_port)
        np.testing.assert_array_equal(got, jax_diff.get_add_time_ids(
            h, w, dynamic_crops=True, rng=rng_jax))
        oh, ow, top, left, th, tw = got[0]
        assert (th, tw) == (h, w) and h <= oh < 3 * h and 0 <= top < oh - h + 1
        assert w <= ow < 3 * w and 0 <= left < ow - w + 1
    assert rng_port.bit_generator.state == rng_jax.bit_generator.state


@pytest.mark.parametrize("name", ["UNET_ATTENTION_TIME_EMBED_DIM", "TEXT_ENCODER_2_PROJECTION_DIM",
                                  "UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM"])
def test_the_2816_guard(name, monkeypatch):
    assert (diff.UNET_ATTENTION_TIME_EMBED_DIM, diff.TEXT_ENCODER_2_PROJECTION_DIM,
            diff.UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM) == (256, 1280, 2816)
    monkeypatch.setattr(diff, name, getattr(diff, name) + 1)
    monkeypatch.setattr(jax_diff, name, getattr(jax_diff, name) + 1)
    with pytest.raises(ValueError, match="added time embedding") as port_err:
        diff.get_add_time_ids(1024, 1024)
    with pytest.raises(ValueError) as jax_err:
        jax_diff.get_add_time_ids(1024, 1024)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dynamic_crops", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_build_pack_matches_jax(dynamic_crops, batch):
    rng = np.random.default_rng(3)
    embeds = {p: (rng.standard_normal((1, 77, 32)).astype(np.float32),
                  rng.standard_normal((1, 8)).astype(np.float32))
              for p in ("t", "p", "u", "n")}
    settings = dict(target="t", positive="p", unconditional="u", neutral="n",
                    batch_size=batch, dynamic_crops=dynamic_crops, resolution=512)
    jpair = jax_trainer.PromptEmbedsPair(
        *(JaxPromptEmbedsXL(jnp.asarray(s), jnp.asarray(q))
          for s, q in (embeds[k] for k in "tpun")), JaxPromptSettings(**settings))
    ppair = PromptEmbedsPair(
        *(PromptEmbedsXL(torch.from_numpy(s), torch.from_numpy(q))
          for s, q in (embeds[k] for k in "tpun")), PromptSettings.from_dict(settings))
    want = jax_trainer.build_pack(jpair, True, 512, 768, rng=np.random.default_rng(9))
    got = trainer.build_pack(ppair, True, 512, 768, rng=np.random.default_rng(9))
    assert set(got) == set(want) == {"inner_embeds", "ref_embeds", "target_embeds",
                                     "inner_added", "ref_added", "target_added"}
    flat_got = flatten_dict(got, sep="/")
    flat_want = flatten_dict(want, sep="/")
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k].numpy(), np.asarray(v), err_msg=k)
    assert flat_got["ref_added/time_ids"].shape == (3 * batch, 6)


def test_sd_pack_has_no_added_conditioning():
    pair = PromptEmbedsPair(*(torch.zeros(1, 77, 8) for _ in range(4)),
                            PromptSettings.from_dict({"target": "a", "batch_size": 2}))
    pack = trainer.build_pack(pair)
    assert set(pack) == {"inner_embeds", "ref_embeds", "target_embeds"}
    assert pack["ref_embeds"].shape == (6, 77, 8)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step(bundles):
    port, jb = copy.deepcopy(bundles[0]), bundles[1]
    optimizer = jax_optim.get_optimizer("adamw", jax_optim.get_lr_schedule("constant", LR, 10))
    settings = JaxPromptSettings(**PROMPT)
    (pair,) = jax_trainer.encode_prompt_pairs([settings], jb.encode_fn, True)
    pack = jax_trainer.build_pack(pair, True, RES, RES, rng=np.random.default_rng(4))
    key = jax.random.PRNGKey(7)
    k_latents, _ = jax.random.split(key)
    latents = np.asarray(jax_diff.get_random_noise(k_latents, PROMPT["batch_size"], RES, RES))
    lora_before = {_port_name(k): np.asarray(v) for k, v in flatten_dict(jb.lora_params).items()}

    lora_in = jax.tree.map(jnp.array, jb.lora_params)  # the step donates its LoRA tree
    opt_state = optimizer.init(lora_in)
    step = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)
    lora_j, opt_state, loss_j = step(
        jb.base_params, lora_in, opt_state, key, pack,
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=RES, width=RES, shard_batch=False)

    bundle = trainer.ModelBundle(unet=port, scheduler=NoiseScheduler("ddim"),
                                 spec=lora.LoRASpec(rank=4, alpha=1.0),
                                 device=torch.device("cpu"))
    ppair = PromptEmbedsPair(*(_port_embeds(e) for e in (pair.target, pair.positive,
                                                        pair.unconditional, pair.neutral)),
                             PromptSettings.from_dict(PROMPT))
    params = bundle.lora_params
    opt = get_optimizer("adamw", list(params.values()), LR)
    step_t = trainer.make_train_step(bundle, opt, MAX_STEPS)
    loss_t = step_t(trainer.build_pack(ppair, True, RES, RES, rng=np.random.default_rng(4)),
                    ppair.guidance_scale, ppair.erase_sign, TIMESTEPS_TO, height=RES, width=RES,
                    latents=torch.tensor(latents.transpose(0, 3, 1, 2)))
    mu = flatten_dict(opt_state[0].mu)
    return dict(
        loss=(float(loss_t), float(loss_j)),
        grads={_port_name(k): (opt.state[params[_port_name(k)]]["exp_avg"] / 0.1,
                               np.asarray(v) / 0.1) for k, v in mu.items()},
        lora={_port_name(k): (params[_port_name(k)].detach(), np.asarray(v))
              for k, v in flatten_dict(lora_j).items()},
        lora_before=lora_before)


def test_xl_step_loss_matches(one_step):
    got, want = one_step["loss"]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_xl_step_gradients_match(one_step):
    """dL/dLoRA from AdamW's first moment on both sides, relative to each
    tensor's size (fp32, other summation orders through the whole UNet)."""
    nonzero = 0
    for name, (got, want) in one_step["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_flax_layout(name, got), want, atol=1e-4 * scale,
                                   err_msg=name)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > 0


def test_xl_step_updated_lora_matches(one_step):
    """The weights after one AdamW step within 1e-4 x the tree's scale (its
    largest weight), and every update of at least lr/2 in the JAX step
    (AdamW's first step moves an entry by lr g / (|g| + eps)) the same sign
    in the port's: only gradients at the rounding level of eps move their
    entries by other fractions of lr."""
    scale = max(float(np.abs(want).max()) for _, want in one_step["lora"].values())
    changed = 0
    for name, (got, want) in one_step["lora"].items():
        got = _flax_layout(name, got)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, err_msg=name)
        before = one_step["lora_before"][name]
        clear = np.abs(want - before) >= 0.5 * LR
        np.testing.assert_array_equal(np.sign(got - before)[clear], np.sign(want - before)[clear],
                                      err_msg=name)
        changed += int(clear.sum())
    assert changed > 0


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------

TRAIN_PROMPTS = [
    dict(target="van gogh", guidance_scale=1.0, resolution=128, dynamic_resolution=True,
         dynamic_crops=True),
    dict(target="cat ears", positive="cat", guidance_scale=2.0, resolution=128,
         dynamic_resolution=True, dynamic_crops=True, action="enhance"),
]
TRAIN = {"iterations": 3, "max_denoising_steps": 3, "lr": 1e-3, "seed": 0,
         "precision": "float32"}


def _fixed_latents(h: int, w: int, n: int) -> np.ndarray:
    """One draw per shape, NHWC: what both trainers start from."""
    return np.random.default_rng(h * 10007 + w + n).standard_normal(
        (n, h // 8, w // 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(bundles, tmp_path_factory):
    """3 iterations of each package's train() on the same weights and prompt
    embeddings, both starting each step from `_fixed_latents`, every
    build_pack call recorded."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        port, jb = copy.deepcopy(bundles[0]), bundles[1]
        jb = jax_trainer.ModelBundle(**{**jb.__dict__, "lora_params": jax.tree.map(
            jnp.array, jb.lora_params)})  # train() donates its LoRA tree
        encode = jb.encode_fn
        records = {"jax": [], "port": []}

        def recorder(real, side, to_np):
            def build(pair, is_xl, height, width, rng=None):
                pack = real(pair, is_xl, height, width, rng=rng)
                records[side].append((float(pair.guidance_scale), height, width,
                                      to_np(pack["target_added"]["time_ids"])[0].tolist()))
                return pack
            return build

        mp.setattr(jax_trainer, "build_pack",
                   recorder(jax_trainer.build_pack, "jax", np.asarray))
        mp.setattr(trainer, "build_pack", recorder(trainer.build_pack, "port",
                                                   lambda t: t.numpy()))
        mp.setattr(jax_diff, "get_initial_latents", lambda key, state, n, h, w, n_prompts=1:
                   jnp.asarray(_fixed_latents(h, w, n)) * state.init_noise_sigma)
        mp.setattr(diff, "get_initial_latents", lambda gen, state, n, h, w, device, n_prompts=1:
                   torch.from_numpy(_fixed_latents(h, w, n).transpose(0, 3, 1, 2))
                   * state.init_noise_sigma)

        jdir = tmp_path_factory.mktemp("jax_train")
        jcfg = jax_config.RootConfig(
            prompts_file="unused.yaml",
            pretrained_model=jax_config.PretrainedModelConfig(name_or_path="random://xl"),
            network=jax_config.NetworkConfig(rank=4, alpha=1.0),
            train=jax_config.TrainConfig(**TRAIN),
            save=jax_config.SaveConfig(name="xl", path=str(jdir), per_steps=200),
            logging=jax_config.LoggingConfig(), other=jax_config.OtherConfig())
        out["jax"] = jax_trainer.train(jcfg, [JaxPromptSettings(**p) for p in TRAIN_PROMPTS], jb)

        pdir = tmp_path_factory.mktemp("port_train")
        bundle = trainer.ModelBundle(
            unet=port, scheduler=NoiseScheduler("ddim"), spec=lora.LoRASpec(rank=4, alpha=1.0),
            device=torch.device("cpu"), encode_fn=lambda p: _port_embeds(encode(p)))
        pcfg = RootConfig.from_dict({
            "prompts_file": "unused.yaml", "pretrained_model": {"name_or_path": "random://xl"},
            "train": TRAIN, "save": {"name": "xl", "path": str(pdir), "per_steps": 200}})
        out["port"] = trainer.train(pcfg, [PromptSettings.from_dict(p) for p in TRAIN_PROMPTS],
                                    bundle)
        out["records"] = records
        out["dirs"] = {"jax": jdir, "port": pdir}
    finally:
        mp.undo()
    return out


def _metrics(directory) -> list:
    return [(r["iteration"], r["timesteps_to"], r["resolution"])
            for r in map(json.loads, (directory / "metrics.jsonl").read_text().splitlines())]


def test_train_draws_the_jax_schedule(runs):
    """The same pair, timesteps_to, bucketed resolution and crop time_ids at
    every iteration: one numpy stream, drawn in the JAX order."""
    jax_records, port_records = runs["records"]["jax"], runs["records"]["port"]
    assert len(port_records) == TRAIN["iterations"]  # dynamic crops: a pack each iteration
    assert port_records == jax_records
    assert len({r[0] for r in port_records}) == 2  # both pairs drawn
    assert _metrics(runs["dirs"]["port"]) == _metrics(runs["dirs"]["jax"])


def test_train_losses_match_jax(runs):
    """From the same latents, the same losses: the first within a step's
    bound (rtol 1e-4), the later ones after one and two AdamW updates
    (lr 1e-3) within 1e-3."""
    got, want = runs["port"]["losses"], runs["jax"]["losses"]
    assert len(got) == len(want) == TRAIN["iterations"] and all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_train_writes_the_jax_export(runs):
    """The AddNet file: the JAX export's names and shapes for the port's
    trained tree, its values equal to what JAX's export writes for it."""
    from safetensors.numpy import load_file

    result = runs["port"]
    tree = {_fold_path(k.rsplit(".", 1)[0]) + (k.rsplit(".", 1)[1],): _flax_layout(k, v)
            for k, v in result["lora"].items()}
    want = jax_lora.export_lora_state(unflatten_dict(tree), jax_lora.LoRASpec(4, 1.0))
    got = load_file(str(runs["dirs"]["port"] / "xl_last.safetensors"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_file = load_file(str(runs["dirs"]["jax"] / "xl_last.safetensors"))
    assert {k: v.shape for k, v in jax_file.items()} == {k: v.shape for k, v in got.items()}
    assert any(k.startswith("lora_unet_down_blocks_1_attentions_1_transformer_blocks_1_")
               for k in got)


class Stop(Exception):
    pass


def test_resume_replays_the_uninterrupted_xl_run(tmp_path):
    """4 iterations with dynamic crops against 3 + resume: the crops' draws
    come from the numpy generator a snapshot restores, so the resumed run is
    the uninterrupted one bit for bit."""
    prompts = [PromptSettings.from_dict(p) for p in TRAIN_PROMPTS]

    def run(directory, resume=False, on_step=None):
        cfg = RootConfig.from_dict({
            "prompts_file": "unused.yaml", "pretrained_model": {"name_or_path": "random://xl"},
            "train": {**TRAIN, "iterations": 4, "save_state": True, "resume": resume},
            "save": {"name": "xl", "path": str(directory), "per_steps": 2}})
        return trainer.train(cfg, prompts, make_random_bundle(config=TINY_XL), on_step=on_step)

    whole = run(tmp_path / "whole")

    def stop(i, loss):
        if i == 3:
            raise Stop

    with pytest.raises(Stop):  # dies in iteration 3, after the snapshot of 2
        run(tmp_path / "cut", on_step=stop)
    resumed = run(tmp_path / "cut", resume=True)
    assert resumed["losses"] == whole["losses"][3:]
    for k, v in whole["lora"].items():
        assert torch.equal(resumed["lora"][k], v), k
    assert _metrics(tmp_path / "cut")[-1] == _metrics(tmp_path / "whole")[-1]
