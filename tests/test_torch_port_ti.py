"""The port's textual-inversion erasure against the JAX package's.

The JAX side is `leco_tpu.testing.make_random_bundle()` (the tiny fp32 UNet,
attn_backend "xla") with a tiny CLIP text encoder; the port gets the same
UNet base weights (`flax_unet_to_torch`, no LoRA layers) and the same CLIP
weights, the synthetic tokenizer on both sides. Each side's step starts
from the JAX step's own latent draw, handed to the port in NCHW, and both
encode the fixed prompts with the JAX encoder. At 128 px the tiny UNet's
level 0 has 256 tokens, so the port's flash route runs, its backward
included (the kernels' plain versions on the CPU)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu import config as jax_config
from leco_tpu.models import clip as jax_clip
from leco_tpu.models.convert import torch_clip_to_flax
from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import make_random_bundle as jax_random_bundle
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import textual_inversion as jax_ti
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch import infer, testing
from leco_tpu_torch.config import RootConfig
from leco_tpu_torch.lora import read_safetensors
from leco_tpu_torch.models import clip
from leco_tpu_torch.models.convert import flax_unet_to_torch
from leco_tpu_torch.models.loader import LoadedModels
from leco_tpu_torch.models.tokenizer import CLIPTokenizer
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptSettings
from leco_tpu_torch.testing import random_clip_state
from leco_tpu_torch.train import diffusion as diff
from leco_tpu_torch.train import textual_inversion as ti
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train.optim import get_optimizer

RES = 128
MAX_STEPS = 4
TIMESTEPS_TO = 2
LR = 5e-3  # examples/ti_config.yaml
PROMPT = dict(target="van gogh", guidance_scale=1.0, resolution=RES, batch_size=1)
TEXT = clip.CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The JAX bundle and handle, and the port's, on the same weights."""
    tok_dir = tmp_path_factory.mktemp("tokenizer")
    testing.write_tokenizer(tok_dir)
    tokenizer = CLIPTokenizer.from_pretrained(str(tok_dir))

    state = random_clip_state(TEXT, seed=3, dtype=torch.float32)
    rng = np.random.default_rng(0)
    state = {k: v + 0.02 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in state.items()}  # biases and LN shifts off zero
    te = clip.CLIPTextModel(TEXT)
    te.load_state_dict(state)
    te.requires_grad_(False)
    j_te = jax_clip.CLIPTextModel(config=jax_clip.CLIPTextConfig(**dataclasses.asdict(TEXT)))
    j_params = jax.tree.map(jnp.asarray, torch_clip_to_flax(
        {k: v.numpy() for k, v in state.items()}, TEXT.num_hidden_layers))

    def jax_encode(prompt: str):
        return j_te.apply({"params": j_params}, jnp.asarray(tokenizer([prompt])))[0]

    jb = jax_random_bundle()
    jb = jax_trainer.ModelBundle(**{**jb.__dict__, "encode_fn": jax_encode})
    cfg = jb.unet.config
    unet = UNet2DConditionModel(
        UNetConfig(**{f: getattr(cfg, f) for f in UNetConfig.__dataclass_fields__}),
        attn_backend="flash")
    unet.load_state_dict(flax_unet_to_torch(jax.tree.map(np.asarray, jb.base_params)))
    unet.requires_grad_(False)
    bundle = trainer.ModelBundle(
        unet=unet, scheduler=NoiseScheduler("ddim"), spec=None, device=torch.device("cpu"),
        encode_fn=lambda p: torch.from_numpy(np.array(jax_encode(p))))
    return {
        "jax": (jb, jax_ti.TextEncoderHandle(model=j_te, params=j_params, tokenizer=tokenizer)),
        "port": (bundle, ti.TextEncoderHandle(model=te, tokenizer=tokenizer,
                                              device=torch.device("cpu"))),
        "tokenizer": tokenizer,
    }


def _jax_pack(jb, settings):
    (pair,) = jax_trainer.encode_prompt_pairs([settings], jb.encode_fn)
    b = settings.batch_size
    return pair, {"uncond_embeds": pair.unconditional, "ref_embeds": jnp.concatenate(
        [jnp.repeat(e, b, axis=0) for e in (pair.positive, pair.neutral, pair.unconditional)])}


def _port_pack(pack) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in pack.items()}


def _counted(names, calls):
    """The flash plain versions wrapped to count their calls."""
    real = {name: getattr(fa, name) for name in names}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn
    return real, {name: counted(name) for name in names}


@pytest.fixture(scope="module")
def one_step(sides):
    jb, jh = sides["jax"]
    bundle, handle = sides["port"]
    settings = JaxPromptSettings(**PROMPT)
    pair, pack = _jax_pack(jb, settings)
    token_ids, slots, emb0 = jax_ti.init_prompt_embedding(jh, settings.target)
    emb0 = np.asarray(emb0)
    optimizer = jax_optim.get_optimizer("adamw", jax_optim.get_lr_schedule("constant", LR, 10))
    opt_state = optimizer.init(jnp.asarray(emb0))
    key = jax.random.PRNGKey(7)
    k_latents, _ = jax.random.split(key)
    state_n = jb.scheduler.set_timesteps(MAX_STEPS)
    latents = np.array(jax_diff.get_initial_latents(k_latents, state_n, 1, RES, RES))
    step_j = jax_ti.make_ti_train_step(jb, jh, token_ids, slots, optimizer, MAX_STEPS)
    emb_j, opt_state, loss_j = step_j(
        jb.base_params, jnp.asarray(emb0), opt_state, key, pack,
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=RES, width=RES)

    p_ids, p_slots, p_emb0 = ti.init_prompt_embedding(handle, settings.target)
    emb = torch.nn.Parameter(p_emb0.clone())
    opt = get_optimizer("adamw", [emb], LR)
    step_t = ti.make_ti_train_step(bundle, handle, p_ids, p_slots, opt, MAX_STEPS)
    calls = {"attn_fwd_plain": 0, "attn_bwd_dq_plain": 0, "attn_bwd_dkv_plain": 0}
    real, counted = _counted(calls, calls)
    try:
        for name, fn in counted.items():
            setattr(fa, name, fn)
        loss_t = step_t(emb, _port_pack(pack), pair.guidance_scale, pair.erase_sign,
                        TIMESTEPS_TO, height=RES, width=RES,
                        latents=torch.from_numpy(latents.transpose(0, 3, 1, 2)))
    finally:
        for name, fn in real.items():
            setattr(fa, name, fn)
    return dict(
        loss=(float(loss_t), float(loss_j)),
        grad=(opt.state[emb]["exp_avg"].numpy() / 0.1, np.asarray(opt_state[0].mu) / 0.1),
        emb=(emb.detach().numpy(), np.asarray(emb_j)),
        emb0=(p_emb0.numpy(), emb0),
        ids=(p_ids.numpy(), np.asarray(token_ids)), slots=(p_slots, slots),
        flash_calls=calls,
    )


@pytest.mark.parametrize("ids,want", [
    ([49406, 5, 9, 49407, 49407, 49407], [1, 2]),  # BOS, two tokens, EOS, pad
    ([49406, 5, 49407, 7, 49407], [1]),  # only up to the first EOS
    ([[49406, 5, 9, 11, 49407]], [1, 2, 3]),  # a (1, N) batch
])
def test_prompt_slots(ids, want):
    np.testing.assert_array_equal(ti.prompt_slots(np.array(ids)), want)
    np.testing.assert_array_equal(ti.prompt_slots(np.array(ids)),
                                  jax_ti.prompt_slots(np.array(ids)))


def test_empty_prompt_is_refused(sides):
    with pytest.raises(ValueError, match="zero trainable"):
        ti.prompt_slots(np.array([[49406, 49407, 49407]]))
    with pytest.raises(ValueError, match="zero trainable"):
        ti.init_prompt_embedding(sides["port"][1], "")


def test_init_prompt_embedding_matches_jax(one_step):
    np.testing.assert_array_equal(one_step["ids"][0], one_step["ids"][1])
    np.testing.assert_array_equal(one_step["slots"][0], one_step["slots"][1])
    got, want = one_step["emb0"]
    assert got.dtype == np.float32 and got.shape == (2, TEXT.hidden_size)
    np.testing.assert_array_equal(got, want)


def test_input_embeds_match_jax(sides):
    """CLIP on spliced input embeddings, both sides, against each other;
    the identity splice is bitwise the plain encode."""
    jb, jh = sides["jax"]
    _, handle = sides["port"]
    ids, slots, emb0 = ti.init_prompt_embedding(handle, "van gogh")
    moved = emb0 + torch.from_numpy(
        np.random.default_rng(1).standard_normal(emb0.shape).astype(np.float32))
    with torch.no_grad():
        plain = handle.model(ids)[0]
        identity = ti.encode_spliced(handle, ids, slots, emb0)
        got = ti.encode_spliced(handle, ids, slots, moved)
    assert torch.equal(identity, plain)
    want = jax_ti.encode_spliced(jh, ids.numpy(), slots, jnp.asarray(moved.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)


def test_input_embeds_keep_the_token_path_unchanged():
    """`input_embeds=None` is the lookup; passing the lookup's own rows (in
    another dtype) gives the same output bitwise."""
    model = clip.CLIPTextModel(TEXT)
    model.load_state_dict(random_clip_state(TEXT, seed=5, dtype=torch.float32))
    ids = torch.randint(0, TEXT.vocab_size - 1, (2, 77), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = model(ids)
        rows = model.text_model.embeddings.token_embedding(ids).double()
        spliced = model(ids, input_embeds=rows)
    for a, b in zip(plain[:2], spliced[:2]):
        assert torch.equal(a, b)


def test_step_takes_the_flash_route(one_step):
    """Level 0 (256 tokens) has 3 self-attentions in the tiny UNet; the step
    runs TIMESTEPS_TO + 2 forwards and differentiates the last one. The
    first self-attention's inputs need no gradient (only the text side
    does, and it enters at the cross-attention after it), so 2 of the 3 run
    the backward."""
    assert one_step["flash_calls"] == {
        "attn_fwd_plain": 3 * (TIMESTEPS_TO + 2),
        "attn_bwd_dq_plain": 2,
        "attn_bwd_dkv_plain": 2,
    }


def test_loss_matches_jax(one_step):
    got, want = one_step["loss"]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_embedding_gradient_matches_jax(one_step):
    """dL/demb, read back from AdamW's first moment (0.1 x g after one step)
    on both sides; the two sides sum in other orders through the UNet and
    CLIP, so the bound is relative to the gradient's size."""
    got, want = one_step["grad"]
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)


def test_updated_rows_match_jax(one_step):
    got, want = one_step["emb"]
    before = one_step["emb0"][1]
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()))
    assert not np.array_equal(got, before)


def test_checkpoint_unet_gives_the_same_gradient(sides):
    """One step with the UNet's blocks recomputed in the backward
    (`checkpoint_unet`, non-reentrant) against one without: the embedding
    is the only input that needs a gradient."""
    bundle, handle = sides["port"]
    jb, _ = sides["jax"]
    _, pack = _jax_pack(jb, JaxPromptSettings(**PROMPT))
    latents = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, RES // 8, RES // 8)).astype(np.float32))
    grads = {}
    try:
        for on in (False, True):
            bundle.unet.checkpoint_unet = on
            ids, slots, emb0 = ti.init_prompt_embedding(handle, "van gogh")
            emb = torch.nn.Parameter(emb0.clone())
            opt = torch.optim.SGD([emb], lr=0.0)
            step = ti.make_ti_train_step(bundle, handle, ids, slots, opt, MAX_STEPS)
            step(emb, _port_pack(pack), 1.0, 1.0, TIMESTEPS_TO, height=RES, width=RES,
                 latents=latents)
            grads[on] = emb.grad.clone()
    finally:
        bundle.unet.checkpoint_unet = False
    assert grads[False].abs().max() > 0
    torch.testing.assert_close(grads[True], grads[False], rtol=1e-6, atol=1e-6 * float(
        grads[False].abs().max()))


# ---------------------------------------------------------------------------
# train_textual_inversion
# ---------------------------------------------------------------------------

ITERATIONS = 3
TRAIN = {"iterations": ITERATIONS, "max_denoising_steps": MAX_STEPS, "lr": LR, "seed": 0,
         "precision": "float32"}


def _fixed_latents(h: int, w: int, n: int) -> np.ndarray:
    """One draw per shape, NHWC: what both loops start each step from."""
    return np.random.default_rng(h * 10007 + w + n).standard_normal(
        (n, h // 8, w // 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(sides, tmp_path_factory):
    """ITERATIONS iterations of each package's train_textual_inversion on the
    same weights, both starting every step from `_fixed_latents`."""
    jb, jh = sides["jax"]
    bundle, handle = sides["port"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_diff, "get_initial_latents", lambda key, state, n, h, w, n_prompts=1:
                   jnp.asarray(_fixed_latents(h, w, n)) * state.init_noise_sigma)
        mp.setattr(diff, "get_initial_latents", lambda gen, state, n, h, w, device, n_prompts=1:
                   torch.from_numpy(_fixed_latents(h, w, n).transpose(0, 3, 1, 2))
                   * state.init_noise_sigma)
        jdir = tmp_path_factory.mktemp("jax_ti")
        jcfg = jax_config.RootConfig(
            prompts_file="unused.yaml",
            pretrained_model=jax_config.PretrainedModelConfig(name_or_path="random://sd"),
            network=jax_config.NetworkConfig(rank=4),
            train=jax_config.TrainConfig(**TRAIN),
            save=jax_config.SaveConfig(name="ti", path=str(jdir), per_steps=1))
        out["jax"] = jax_ti.train_textual_inversion(jcfg, [JaxPromptSettings(**PROMPT)], jb, jh)
        out["jax_dir"] = jdir
        pdir = tmp_path_factory.mktemp("port_ti")
        pcfg = RootConfig.from_dict({
            "prompts_file": "unused.yaml", "pretrained_model": {"name_or_path": "random://sd"},
            "train": TRAIN, "save": {"name": "ti", "path": str(pdir), "per_steps": 1}})
        out["port"] = ti.train_textual_inversion(pcfg, [PromptSettings.from_dict(PROMPT)],
                                                 bundle, handle)
        out["port_dir"] = pdir
    return out


def test_train_draws_the_jax_schedule(runs):
    def tsto(d):
        return [json.loads(ln)["timesteps_to"]
                for ln in (d / "metrics.jsonl").read_text().splitlines()]

    want = tsto(runs["jax_dir"])
    assert tsto(runs["port_dir"]) == want
    rng = np.random.default_rng(0)  # seed 0: the draws of the JAX loop
    assert want == [int(rng.integers(1, MAX_STEPS)) for _ in range(ITERATIONS)]
    records = [json.loads(ln) for ln in (runs["port_dir"] / "metrics.jsonl").read_text()
               .splitlines()]
    assert [sorted(r) for r in records] == [["iteration", "loss", "lr", "timesteps_to"]] * 3
    assert [r["lr"] for r in records] == [LR] * ITERATIONS


def test_train_matches_jax(runs):
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], rtol=1e-4)
    got, want = runs["port"]["embedding"].numpy(), np.asarray(runs["jax"]["embedding"])
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()))


def test_train_saves_what_jax_saves(runs):
    """The same files at the same iterations, each an `emb_params` (n, hidden)
    with the metadata name, config and target, and the last one the
    returned embedding."""
    names = [p.name for p in runs["port"]["saved"]]
    assert names == [p.name for p in runs["jax"]["saved"]] == [
        "ti_1steps_ti.safetensors", "ti_ti.safetensors"]
    for port_file, jax_file in zip(runs["port"]["saved"], runs["jax"]["saved"]):
        got, meta = read_safetensors(port_file)
        want, jmeta = read_safetensors(jax_file)
        assert list(got) == list(want) == ["emb_params"]
        assert got["emb_params"].shape == want["emb_params"].shape == (2, TEXT.hidden_size)
        assert set(meta) == set(jmeta) == {"name", "config", "target"}
        assert (meta["name"], meta["target"]) == (jmeta["name"], jmeta["target"]) == (
            "ti", "van gogh")
        assert json.loads(meta["config"])["train"]["lr"] == LR
    assert torch.equal(ti.load_embedding(runs["port"]["saved"][-1]),
                       runs["port"]["embedding"])


@pytest.mark.parametrize("case", ["two prompts", "sdxl"])
def test_train_refusals(sides, tmp_path, case):
    bundle, handle = sides["port"]
    prompts = [PromptSettings.from_dict(PROMPT)]
    if case == "two prompts":
        prompts = prompts + [PromptSettings.from_dict({**PROMPT, "target": "cat"})]
        match = "one concept"
    else:
        bundle = testing.make_random_bundle(config=testing.tiny_xl_unet_config())
        match = "SD1.x/2.x"
    cfg = RootConfig.from_dict({
        "prompts_file": "unused.yaml", "pretrained_model": {"name_or_path": "random://sd"},
        "train": TRAIN, "save": {"name": "ti", "path": str(tmp_path)}})
    with pytest.raises(ValueError, match=match):
        ti.train_textual_inversion(cfg, prompts, bundle, handle)


def test_non_finite_loss_stops_the_run(sides, tmp_path, monkeypatch):
    bundle, handle = sides["port"]
    monkeypatch.setattr(ti, "esd_loss", lambda *a: torch.tensor(float("nan"),
                                                                requires_grad=True))
    cfg = RootConfig.from_dict({
        "prompts_file": "unused.yaml", "pretrained_model": {"name_or_path": "random://sd"},
        "train": {**TRAIN, "max_denoising_steps": 2},
        "save": {"name": "ti", "path": str(tmp_path), "per_steps": 1}})
    with pytest.raises(FloatingPointError, match="iteration 0"):
        ti.train_textual_inversion(cfg, [PromptSettings.from_dict({**PROMPT, "resolution": 64})],
                                   bundle, handle)
    assert not list(tmp_path.glob("*.safetensors"))


@pytest.mark.parametrize("suffix", [".safetensors", ".pt"])
def test_embedding_file_layout(tmp_path, suffix):
    emb = torch.arange(16, dtype=torch.float32).reshape(2, 8) / 7
    f = tmp_path / f"e{suffix}"
    ti.save_embedding(f, emb, "concept", torch.bfloat16, {"target": "van gogh"})
    loaded = ti.load_embedding(f)
    assert loaded.dtype == torch.bfloat16 and torch.equal(loaded, emb.bfloat16())
    if suffix == ".safetensors":
        state, meta = read_safetensors(f)
        assert list(state) == ["emb_params"] and meta == {"name": "concept",
                                                          "target": "van gogh"}
    else:  # torch.save of the same dict, never an .npz
        assert list(torch.load(f, weights_only=True)) == ["emb_params"]
        assert not list(tmp_path.glob("*.npz"))


def test_identity_splice_generates_the_plain_prompts_image(sides):
    """`generate_latents(positive_embeds=encode_spliced(...))` with the
    table's own rows is the plain prompt's generation; moved rows move it."""
    bundle, handle = sides["port"]
    models = LoadedModels(tokenizer=handle.tokenizer, text_encoder=handle.model,
                          unet=bundle.unet, scheduler=bundle.scheduler,
                          unet_config=bundle.unet.cfg)
    gen = infer.GenerationConfig(height=64, width=64, num_inference_steps=2, seed=5)
    ids, slots, emb0 = ti.init_prompt_embedding(handle, "van gogh")
    with torch.no_grad():
        base = infer.generate_latents(models, "van gogh", "", gen)
        same = infer.generate_latents(models, "van gogh", "", gen,
                                      positive_embeds=ti.encode_spliced(handle, ids, slots, emb0))
        moved = infer.generate_latents(
            models, "van gogh", "", gen,
            positive_embeds=ti.encode_spliced(handle, ids, slots, emb0 + 0.5))
    assert torch.equal(base, same)
    assert not torch.allclose(base, moved)
