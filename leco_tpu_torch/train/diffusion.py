"""Diffusion ops: latent init, offset noise, embedding packing, CFG noise
prediction, the partial-denoise sampler and resolution buckets.

Counterpart of `leco_tpu/train/diffusion.py` (reference train_util.py).
Latents are NCHW. Noise comes from an explicit `torch.Generator`; it cannot
reproduce the JAX package's `jax.random` draws, so the train step also takes
its latents as an argument, and `diffusion` its per-step noise as a
callable (the parity tests feed both sides one draw). The JAX package's
traced-bound `fori_loop` becomes a Python loop under no_grad, with LMS's
derivative history in the loop's state.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from leco_tpu_torch.ops import schedulers as sched

UNET_IN_CHANNELS = 4  # train_util.py:12
VAE_SCALE_FACTOR = 8  # train_util.py:13


def get_random_noise(generator: torch.Generator, batch_size: int, height: int,
                     width: int, device) -> torch.Tensor:
    """(B, 4, H/8, W/8) standard normal fp32 (train_util.py:20-32)."""
    return torch.randn(
        (batch_size, UNET_IN_CHANNELS, height // VAE_SCALE_FACTOR,
         width // VAE_SCALE_FACTOR),
        generator=generator, device=device, dtype=torch.float32,
    )


def apply_noise_offset(generator: torch.Generator, latents: torch.Tensor,
                       noise_offset: float) -> torch.Tensor:
    """Offset noise (train_util.py:36-40): a per-(batch, channel) DC shift
    of `noise_offset` standard normals."""
    shift = torch.randn((latents.shape[0], latents.shape[1], 1, 1), generator=generator,
                        device=latents.device, dtype=latents.dtype)
    return latents + noise_offset * shift


def get_initial_latents(generator: torch.Generator, state: sched.SchedulerState,
                        n_imgs: int, height: int, width: int, device,
                        n_prompts: int = 1) -> torch.Tensor:
    """noise * init_noise_sigma, tiled over prompts (train_util.py:43-57)."""
    noise = get_random_noise(generator, n_imgs, height, width, device)
    return noise.repeat(n_prompts, 1, 1, 1) * state.init_noise_sigma


def concat_embeddings(unconditional: torch.Tensor, conditional: torch.Tensor,
                      n_imgs: int) -> torch.Tensor:
    """cat([uncond, cond]).repeat_interleave(n_imgs, 0) (train_util.py:133-138).
    (1, 77, d) inputs -> (2*n_imgs, 77, d)."""
    return torch.cat([unconditional, conditional], dim=0).repeat_interleave(n_imgs, dim=0)


def predict_noise(unet: Callable, state: sched.SchedulerState, step_index: int,
                  latents: torch.Tensor, text_embeddings: torch.Tensor,
                  guidance_scale: float = 7.5) -> torch.Tensor:
    """One CFG prediction on the packed (2B, 77, d) uncond+cond batch
    (train_util.py:142-168)."""
    latent_in = torch.cat([latents] * 2, dim=0)
    latent_in = sched.scale_model_input(state, latent_in, step_index)
    t = float(state.timesteps[step_index])
    noise_pred = unet(latent_in, t, text_embeddings)
    uncond, text = noise_pred.chunk(2, dim=0)
    return uncond + guidance_scale * (text - uncond)


@torch.no_grad()
def diffusion(unet: Callable, state: sched.SchedulerState, latents: torch.Tensor,
              text_embeddings: torch.Tensor, total_timesteps: int,
              guidance_scale: float = 3.0,
              noise: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
    """Partial denoise from pure noise for `total_timesteps` steps of the
    `state` schedule (train_util.py:171-193). `noise(i)` gives step i's
    standard normal of the latents' shape; ddpm and euler_a need it."""
    kind = state.kind
    if sched.needs_noise(kind) and noise is None:
        raise ValueError(f"scheduler {kind} needs a noise source")
    history = (torch.zeros((sched.LMS_ORDER,) + tuple(latents.shape), dtype=torch.float32,
                           device=latents.device) if kind == "lms" else None)
    for i in range(total_timesteps):
        noise_pred = predict_noise(unet, state, i, latents, text_embeddings,
                                   guidance_scale=guidance_scale)
        if kind == "ddim":
            latents = sched.step_ddim(state, noise_pred, i, latents)
        elif kind == "ddpm":
            latents = sched.step_ddpm(state, noise_pred, i, latents, noise(i))
        elif kind == "euler_a":
            latents = sched.step_euler_a(state, noise_pred, i, latents, noise(i))
        elif kind == "lms":
            latents, history = sched.step_lms(state, noise_pred, i, latents, history)
        else:
            raise ValueError(kind)
    return latents


def get_random_resolution_in_bucket(rng: np.random.Generator,
                                    bucket_resolution: int = 512) -> tuple[int, int]:
    """Random (h, w) multiples of 64 in [res/2, res) — the upper bound is
    exclusive (train_util.py:404-416, SURVEY.md quirk 13)."""
    step = 64
    min_step = bucket_resolution // 2 // step
    max_step = bucket_resolution // step
    height = int(rng.integers(min_step, max_step)) * step
    width = int(rng.integers(min_step, max_step)) * step
    return height, width
