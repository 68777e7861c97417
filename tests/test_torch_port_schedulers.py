"""The port's DDIM scheduler against the JAX package's: the host-side tables
and the torch step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.ops import schedulers as jax_sched
from leco_tpu_torch.ops import schedulers as sched

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
    for kind in ("ddpm", "lms", "euler_a"):
        with pytest.raises(NotImplementedError):
            sched.create_noise_scheduler(kind)
    with pytest.raises(ValueError):
        sched.NoiseScheduler("heun")
    with pytest.raises(ValueError):
        sched.NoiseScheduler("ddim", prediction_type="sample")
