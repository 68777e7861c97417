"""The port's schedulers (DDIM, DDPM, LMS, Euler-ancestral) against the JAX
package's: the host-side tables, the torch steps (the stochastic ones with
the JAX step's own noise, `jax.random.normal(fold_in(key, i))`, handed over
in NCHW), and the partial-denoise loop on a toy UNet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.ops import schedulers as jax_sched
from leco_tpu.train import diffusion as jax_diff
from leco_tpu_torch.ops import schedulers as sched
from leco_tpu_torch.train import diffusion as diff

TABLES = ("timesteps", "input_scales", "sqrt_alpha_t", "sqrt_one_minus_alpha_t",
          "sqrt_alpha_prev", "sqrt_one_minus_alpha_prev")


@pytest.mark.parametrize("n", [1, 4, 50, 1000])
def test_ddim_tables_equal_jax(n):
    got = sched.NoiseScheduler("ddim").set_timesteps(n)
    want = jax_sched.NoiseScheduler("ddim").set_timesteps(n)
    for name in TABLES:
        # the same float64 host computation, stored as float32: bit-equal
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.init_noise_sigma == float(want.init_noise_sigma)
    assert got.num_inference_steps == want.num_inference_steps == n


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("i", [0, 17, 49])
def test_step_ddim_matches_jax(prediction_type, i):
    rng = np.random.default_rng(i)
    out, sample = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    state = sched.NoiseScheduler("ddim", prediction_type).set_timesteps(50)
    jstate = jax_sched.NoiseScheduler("ddim", prediction_type).set_timesteps(50)
    got = sched.step_ddim(state, torch.from_numpy(out), i, torch.from_numpy(sample))
    want = jax_sched.step_ddim(jstate, jnp.asarray(out), i, jnp.asarray(sample))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    scaled = sched.scale_model_input(state, torch.from_numpy(sample), i)
    np.testing.assert_array_equal(
        scaled.numpy(), np.asarray(jax_sched.scale_model_input(jstate, jnp.asarray(sample), i))
    )


def test_unported_and_unknown_kinds():
    """Every kind of the JAX package is ported; unknown names still raise."""
    for kind in ("ddim", "ddpm", "lms", "euler_a", "Euler A"):
        assert sched.create_noise_scheduler(kind).kind in sched.AVAILABLE_SCHEDULERS
    with pytest.raises(ValueError):
        sched.NoiseScheduler("heun")
    with pytest.raises(ValueError):
        sched.NoiseScheduler("ddim", prediction_type="sample")


ALL_TABLES = TABLES + ("ddpm_x0_coef", "ddpm_xt_coef", "ddpm_std", "sigmas", "lms_coeffs",
                       "euler_sigma_down", "euler_sigma_up")


@pytest.mark.parametrize("n", [1, 4, 50, 1000])
@pytest.mark.parametrize("kind", ["ddpm", "lms", "euler_a"])
def test_tables_equal_jax(kind, n):
    got = sched.NoiseScheduler(kind, "v_prediction").set_timesteps(n)
    want = jax_sched.NoiseScheduler(kind, "v_prediction").set_timesteps(n)
    for name in ALL_TABLES:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == np.float32, name
    assert got.init_noise_sigma == float(want.init_noise_sigma)
    assert got.num_inference_steps == n and got.kind == kind


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("kind", ["ddpm", "lms", "euler_a"])
def test_steps_match_jax(kind, prediction_type):
    state = sched.NoiseScheduler(kind, prediction_type).set_timesteps(50)
    jstate = jax_sched.NoiseScheduler(kind, prediction_type).set_timesteps(50)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(11)
    hist = torch.zeros((sched.LMS_ORDER, 2, 4, 8, 8))
    jhist = jnp.zeros((sched.LMS_ORDER, 2, 8, 8, 4))
    for i in (0, 1, 2, 3, 17, 49):  # LMS: the history fills over the first steps
        out, sample = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
        ki = jax.random.fold_in(key, i)
        t_out, t_sample = _nchw(out), _nchw(sample)
        if kind == "lms":
            want, jhist = jax_sched.step_lms(jstate, jnp.asarray(out), i, jnp.asarray(sample),
                                             jhist)
            got, hist = sched.step_lms(state, t_out, i, t_sample, hist)
            np.testing.assert_allclose(hist.numpy(), np.asarray(jhist).transpose(0, 1, 4, 2, 3),
                                       rtol=1e-6, atol=1e-6)
        else:
            noise = _nchw(jax.random.normal(ki, sample.shape, jnp.float32))
            step_j = jax_sched.step_ddpm if kind == "ddpm" else jax_sched.step_euler_a
            step_t = sched.step_ddpm if kind == "ddpm" else sched.step_euler_a
            want = step_j(jstate, jnp.asarray(out), i, jnp.asarray(sample), ki)
            got = step_t(state, t_out, i, t_sample, noise)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-6, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_array_equal(
            sched.scale_model_input(state, t_sample, i).numpy(),
            np.asarray(jax_sched.scale_model_input(jstate, jnp.asarray(sample), i))
            .transpose(0, 3, 1, 2))


@pytest.mark.parametrize("kind", ["ddim", "ddpm", "lms", "euler_a"])
def test_diffusion_loop_matches_jax(kind):
    """10 steps of the CFG partial denoise on a toy UNet (elementwise in the
    latents plus a per-sample mean of the context, so layout-free)."""
    state = sched.NoiseScheduler(kind, "epsilon").set_timesteps(20)
    jstate = jax_sched.NoiseScheduler(kind, "epsilon").set_timesteps(20)
    rng = np.random.default_rng(5)
    noise0 = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    emb = rng.standard_normal((2, 77, 16)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def unet_j(x, t, ctx, added=None):
        return jnp.tanh(x) * 0.5 + t / 1000.0 + ctx.mean(axis=(1, 2))[:, None, None, None]

    def unet_t(x, t, ctx):
        return torch.tanh(x) * 0.5 + t / 1000.0 + ctx.mean(dim=(1, 2))[:, None, None, None]

    latents_j = jnp.asarray(noise0) * jstate.init_noise_sigma
    want = jax_diff.diffusion(unet_j, jstate, key, latents_j, jnp.asarray(emb), 10,
                              guidance_scale=3.0)
    latents_t = _nchw(noise0) * state.init_noise_sigma
    got = diff.diffusion(
        unet_t, state, latents_t, torch.from_numpy(emb), 10, guidance_scale=3.0,
        noise=lambda i: _nchw(jax.random.normal(jax.random.fold_in(key, i), noise0.shape,
                                                jnp.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    if sched.needs_noise(kind):
        with pytest.raises(ValueError):
            diff.diffusion(unet_t, state, latents_t, torch.from_numpy(emb), 2)
