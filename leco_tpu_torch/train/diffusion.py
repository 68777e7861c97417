"""Diffusion ops: latent init, offset noise, embedding packing, CFG noise
prediction, the partial-denoise sampler and resolution buckets.

Counterpart of `leco_tpu/train/diffusion.py` (reference train_util.py).
Latents are NCHW. Noise comes from an explicit `torch.Generator`; it cannot
reproduce the JAX package's `jax.random` draws, so the train step also takes
its latents as an argument, and `diffusion` its per-step noise as a
callable (the parity tests feed both sides one draw). The JAX package's
traced-bound `fori_loop` becomes a Python loop under no_grad, with LMS's
derivative history in the loop's state. SDXL's micro-conditioning
(`get_add_time_ids`) draws from the trainer's numpy generator in the JAX
order, and `predict_noise` / `diffusion` hand SDXL's `added_cond_kwargs`
to every UNet call.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from leco_tpu_torch.ops import schedulers as sched
from leco_tpu_torch.utils.profiling import count

UNET_IN_CHANNELS = 4  # train_util.py:12
VAE_SCALE_FACTOR = 8  # train_util.py:13
UNET_ATTENTION_TIME_EMBED_DIM = 256  # train_util.py:15 (XL)
TEXT_ENCODER_2_PROJECTION_DIM = 1280  # train_util.py:16
UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM = 2816  # train_util.py:17


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
                  guidance_scale: float = 7.5,
                  added_cond_kwargs: Optional[dict] = None) -> torch.Tensor:
    """One CFG prediction on the packed (2B, 77, d) uncond+cond batch
    (train_util.py:142-168); SDXL's `added_cond_kwargs` go to the UNet."""
    latent_in = torch.cat([latents] * 2, dim=0)
    latent_in = sched.scale_model_input(state, latent_in, step_index)
    t = float(state.timesteps[step_index])
    if added_cond_kwargs is None:
        noise_pred = unet(latent_in, t, text_embeddings)
    else:
        noise_pred = unet(latent_in, t, text_embeddings, added_cond_kwargs)
    uncond, text = noise_pred.chunk(2, dim=0)
    return uncond + guidance_scale * (text - uncond)


@torch.no_grad()
def diffusion(unet: Callable, state: sched.SchedulerState, latents: torch.Tensor,
              text_embeddings: torch.Tensor, total_timesteps: int,
              guidance_scale: float = 3.0,
              noise: Optional[Callable[[int], torch.Tensor]] = None,
              added_cond_kwargs: Optional[dict] = None) -> torch.Tensor:
    """Partial denoise from pure noise for `total_timesteps` steps of the
    `state` schedule (train_util.py:171-193). `noise(i)` gives step i's
    standard normal of the latents' shape; ddpm and euler_a need it.
    `added_cond_kwargs` (SDXL) go to every UNet call."""
    kind = state.kind
    if sched.needs_noise(kind) and noise is None:
        raise ValueError(f"scheduler {kind} needs a noise source")
    history = (torch.zeros((sched.LMS_ORDER,) + tuple(latents.shape), dtype=torch.float32,
                           device=latents.device) if kind == "lms" else None)
    for i in range(total_timesteps):
        count("unet.inner_calls")
        noise_pred = predict_noise(unet, state, i, latents, text_embeddings,
                                   guidance_scale=guidance_scale,
                                   added_cond_kwargs=added_cond_kwargs)
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


def get_add_time_ids(height: int, width: int, dynamic_crops: bool = False,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """SDXL micro-conditioning [orig_h, orig_w, crop_top, crop_left,
    target_h, target_w] as a (1, 6) float32 array (train_util.py:294-330).
    Under `dynamic_crops` the original size is (h, w) scaled by a draw in
    [1, 3) and the crop's corner two draws inside it, from `rng` in the JAX
    order: `rng.random()`, then two `rng.integers`."""
    if dynamic_crops:
        rng = rng or np.random.default_rng()
        random_scale = float(rng.random()) * 2 + 1
        original_size = (int(height * random_scale), int(width * random_scale))
        crops_coords_top_left = (int(rng.integers(0, original_size[0] - height)),
                                 int(rng.integers(0, original_size[1] - width)))
    else:
        original_size = (height, width)
        crops_coords_top_left = (0, 0)
    add_time_ids = list(original_size + crops_coords_top_left + (height, width))

    passed_add_embed_dim = (UNET_ATTENTION_TIME_EMBED_DIM * len(add_time_ids)
                            + TEXT_ENCODER_2_PROJECTION_DIM)
    if passed_add_embed_dim != UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM:
        raise ValueError(
            f"Model expects an added time embedding vector of length "
            f"{UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM}, but a vector of "
            f"{passed_add_embed_dim} was created.")
    return np.array([add_time_ids], dtype=np.float32)


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
