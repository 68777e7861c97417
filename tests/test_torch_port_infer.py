"""The port's inference against the JAX package's (`leco_tpu/infer.py`).

One tiny diffusers checkpoint (`leco_tpu_torch.testing`) is loaded by both
packages with c3lier LoRA (so the upsampler's routing changes with the
multiplier), fp32. A LoRA tree is drawn from a numpy seed. The denoise
runner under `generate_latents` (JAX: `_get_runner`'s `run`; the port:
`denoise` under `applied_lora`) is fed the same numpy latents and text
embeddings on both sides, at multipliers -1, 0 and +1 and in the list form,
with DDIM and LMS at guidance 7, and held within 1e-4 x max|ref| + 1e-5
(fp32: the same UNet in other summation orders, through 3 steps at
guidance 7). Then the
port's own generate_latents: seed determinism, prompts, noise_offset,
positive_embeds, the list form's spec, and the model left as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu import infer as jax_infer
from leco_tpu import lora as jax_lora
from leco_tpu.models import loader as jax_loader
from leco_tpu_torch import infer, lora, testing
from leco_tpu_torch.models import loader
from leco_tpu_torch.models.clip import CLIPTextConfig
from leco_tpu_torch.models.unet import tiny_unet_config
from leco_tpu_torch.ops.schedulers import create_noise_scheduler
from test_torch_port_lora_tree import to_flax

SPEC = dict(rank=2, alpha=1.0, network_type="c3lier")
STEPS, GUIDANCE = 3, 7.0
GEN = infer.GenerationConfig(height=64, width=64, num_inference_steps=STEPS, seed=7)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    return testing.write_diffusers_checkpoint(
        root, tiny_unet_config(32),
        CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2), seed=5)


@pytest.fixture(scope="module")
def models(ckpt):
    pm = loader.load_models(str(ckpt), "ddim", lora_spec=lora.LoRASpec(**SPEC), device="cpu")
    jm = jax_loader.load_models(str(ckpt), "ddim", lora_spec=jax_lora.LoRASpec(**SPEC),
                                remat=False)
    rng = np.random.default_rng(0)
    ref = lora.lora_parameters(pm.unet)
    trees = [{k: torch.from_numpy((0.05 * rng.standard_normal(v.shape)).astype(np.float32))
              for k, v in ref.items()} for _ in range(2)]
    return dict(port=pm, jax=jm, trees=trees)


def _jax_params(jm, lora_arg, multiplier):
    """The parameter tree the JAX package's generate_latents builds."""
    spec = jax_lora.LoRASpec(**SPEC)
    if isinstance(lora_arg, list):
        return jax_lora.compose_lora_params(
            jm.unet_base_params, [(to_flax(t), m) for t, m in lora_arg], spec)
    if lora_arg is not None and multiplier != 0.0:
        return jax_lora.merge_params(jm.unet_base_params,
                                     jax_lora.scale_lora_tree(to_flax(lora_arg), multiplier))
    return jm.unet_base_params


@pytest.mark.parametrize("kind", ["ddim", "lms"])
@pytest.mark.parametrize("form", ["-1", "0", "+1", "list"])
def test_denoise_runner_matches_jax(models, kind, form):
    pm, jm, (a, b) = models["port"], models["jax"], models["trees"]
    if form == "list":
        lora_arg, multiplier = [(a, 0.5), (b, -1.0), (a, 0.0)], 1.0
    else:
        lora_arg, multiplier = a, float(form)
    rng = np.random.default_rng(1)
    latents = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    emb = np.concatenate([np.asarray(jax_infer._encode(jm, "")),
                          np.asarray(jax_infer._encode(jm, "van gogh"))])
    jstate = jax_loader.create_noise_scheduler(kind).set_timesteps(STEPS)
    run = jax_infer._get_runner(jm, jstate, GUIDANCE, False)
    want = np.asarray(run(_jax_params(jm, lora_arg, multiplier), jax.random.PRNGKey(0),
                          jnp.asarray(latents * jstate.init_noise_sigma), jnp.asarray(emb),
                          None))

    state = create_noise_scheduler(kind).set_timesteps(STEPS)
    before = {k: v.detach().clone() for k, v in lora.lora_parameters(pm.unet).items()}
    with infer.applied_lora(pm.unet, lora_arg, multiplier, lora.LoRASpec(**SPEC)):
        got = infer.denoise(pm.unet, state,
                            torch.from_numpy(latents.transpose(0, 3, 1, 2)) * state.init_noise_sigma,
                            torch.from_numpy(emb), GUIDANCE).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL + RTOL * np.abs(want).max())
    for k, v in lora.lora_parameters(pm.unet).items():  # the model as it was
        assert torch.equal(v, before[k]), k
    assert all(m.mode == "on" and m.folded is None for _, m in lora.lora_layers(pm.unet))


def test_encode_matches_jax(models):
    got = infer._encode(models["port"], "van gogh").numpy()
    want = np.asarray(jax_infer._encode(models["jax"], "van gogh"))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_generate_is_seeded_and_prompted(models):
    pm = models["port"]
    a = infer.generate_latents(pm, "van gogh", "", GEN)
    assert a.shape == (1, 4, 8, 8) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(infer.generate_latents(pm, "van gogh", "", GEN), a, rtol=0, atol=0)
    assert not torch.allclose(infer.generate_latents(pm, "cat", "", GEN), a)
    other_seed = infer.GenerationConfig(**{**GEN.__dict__, "seed": 8})
    assert not torch.allclose(infer.generate_latents(pm, "van gogh", "", other_seed), a)


def test_ab_compare_multiplier_semantics(models):
    """Multiplier 0 is the model without the LoRA; -1 and +1 differ from it
    and from each other; the list form at (0.5, 0.5) is the single form at
    1.0 (fp32, the fold against the branch)."""
    pm, tree = models["port"], models["trees"][0]
    grid = infer.ab_compare(pm, tree, "van gogh", gen=GEN)
    base = infer.generate_latents(pm, "van gogh", "", GEN)
    torch.testing.assert_close(grid[0.0], base, rtol=0, atol=0)
    assert not torch.allclose(grid[1.0], base) and not torch.allclose(grid[-1.0], grid[1.0])
    composed = infer.generate_latents(pm, "van gogh", "", GEN, lora=[(tree, 0.5), (tree, 0.5)],
                                      spec=lora.LoRASpec(**SPEC))
    torch.testing.assert_close(composed, grid[1.0], atol=1e-4, rtol=1e-4)


def test_noise_offset_shifts_the_start(models):
    pm = models["port"]
    a = infer.generate_latents(pm, "van gogh", "", GEN)
    shifted = infer.GenerationConfig(**{**GEN.__dict__, "noise_offset": 0.5})
    assert not torch.allclose(infer.generate_latents(pm, "van gogh", "", shifted), a)


def test_positive_embeds_replace_the_prompt(models):
    pm = models["port"]
    a = infer.generate_latents(pm, "van gogh", "", GEN)
    same = infer.generate_latents(pm, "cat", "", GEN,
                                  positive_embeds=infer._encode(pm, "van gogh"))
    torch.testing.assert_close(same, a, rtol=0, atol=0)


def test_list_form_needs_a_spec(models):
    with pytest.raises(ValueError, match="spec"):
        infer.generate_latents(models["port"], "van gogh", "", GEN,
                               lora=[(models["trees"][0], 1.0)])


def test_a_lora_the_model_has_no_branch_for_raises(models):
    tree = {**models["trees"][0], "mid_block.nowhere.lora_down": torch.zeros(2, 4)}
    with pytest.raises(KeyError, match="no branch"):
        infer.generate_latents(models["port"], "van gogh", "", GEN, lora=tree)
    assert all(m.mode == "on" for _, m in lora.lora_layers(models["port"].unet))


def test_stochastic_scheduler_draws_its_noise(models, monkeypatch):
    pm = models["port"]
    monkeypatch.setattr(pm, "scheduler", create_noise_scheduler("euler_a"))
    a = infer.generate_latents(pm, "van gogh", "", GEN)
    torch.testing.assert_close(infer.generate_latents(pm, "van gogh", "", GEN), a, rtol=0, atol=0)
    assert torch.isfinite(a).all()


def test_sdxl_models_are_refused(models, monkeypatch):
    """SDXL generates (tests/test_torch_port_sdxl_infer.py);
    what it still refuses, as the JAX package does, is `positive_embeds`
    (a textual-inversion embedding of SD1.x/2.x), before any work."""
    import dataclasses

    pm = models["port"]
    xl = dataclasses.replace(pm.unet.cfg, addition_embed_type="text_time")
    monkeypatch.setattr(pm.unet, "cfg", xl)
    assert pm.is_xl
    with pytest.raises(ValueError, match="positive_embeds"):
        infer.generate_latents(pm, "van gogh", "", GEN, positive_embeds=torch.zeros(1, 77, 32))
