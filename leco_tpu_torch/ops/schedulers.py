"""DDIM noise scheduler: numpy tables built host-side, torch step functions.

Counterpart of `leco_tpu/ops/schedulers.py`, DDIM only for now (the slice's
recipe). The beta schedule (scaled_linear over [0.00085, 0.012], 1000 train
timesteps) and the per-inference-step gather tables are computed in float64
numpy at `set_timesteps` time, exactly as the JAX package does, and stored as
float32; `scale_model_input` and `step_ddim` are torch. DDPM, LMS and
Euler-ancestral raise NotImplementedError (queued in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BETA_START = 0.00085
BETA_END = 0.012
NUM_TRAIN_TIMESTEPS = 1000

AVAILABLE_SCHEDULERS = ("ddim", "ddpm", "lms", "euler_a")
PORTED_SCHEDULERS = ("ddim",)


def _alphas_cumprod(num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """scaled_linear beta schedule -> cumulative alpha products (float64)."""
    betas = (
        np.linspace(
            BETA_START**0.5, BETA_END**0.5, num_train_timesteps, dtype=np.float64
        )
        ** 2
    )
    return np.cumprod(1.0 - betas)


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Per-inference-schedule float32 tables, indexed by the step index."""

    kind: str
    prediction_type: str
    num_inference_steps: int
    timesteps: np.ndarray  # the value fed to the UNet's timestep embedding
    input_scales: np.ndarray  # x_t scale of scale_model_input (1 for ddim)
    init_noise_sigma: float
    sqrt_alpha_t: np.ndarray
    sqrt_one_minus_alpha_t: np.ndarray
    sqrt_alpha_prev: np.ndarray
    sqrt_one_minus_alpha_prev: np.ndarray


class NoiseScheduler:
    """Factory for `SchedulerState`s (model_util.create_noise_scheduler in
    the reference)."""

    def __init__(
        self,
        kind: str = "ddim",
        prediction_type: str = "epsilon",
        num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
    ):
        kind = kind.lower().replace(" ", "_")
        if kind not in AVAILABLE_SCHEDULERS:
            raise ValueError(f"Unknown scheduler name: {kind}")
        if kind not in PORTED_SCHEDULERS:
            raise NotImplementedError(f"scheduler {kind} is not ported yet")
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"Unknown prediction_type: {prediction_type}")
        self.kind = kind
        self.prediction_type = prediction_type
        self.num_train_timesteps = num_train_timesteps
        self.alphas_cumprod = _alphas_cumprod(num_train_timesteps)

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        T = self.num_train_timesteps
        n = num_inference_steps
        acp = self.alphas_cumprod
        # "leading" spacing (diffusers default for DDIM)
        step_ratio = T // n
        timesteps = (np.arange(n) * step_ratio).round()[::-1].astype(np.int64)
        prev_timesteps = timesteps - step_ratio
        alpha_t = acp[timesteps]
        alpha_prev = np.where(
            prev_timesteps >= 0, acp[np.clip(prev_timesteps, 0, T - 1)], 1.0
        )
        f32 = np.float32
        return SchedulerState(
            kind=self.kind,
            prediction_type=self.prediction_type,
            num_inference_steps=n,
            timesteps=timesteps.astype(f32),
            input_scales=np.ones((n,), f32),
            init_noise_sigma=1.0,
            sqrt_alpha_t=np.sqrt(alpha_t).astype(f32),
            sqrt_one_minus_alpha_t=np.sqrt(1.0 - alpha_t).astype(f32),
            sqrt_alpha_prev=np.sqrt(alpha_prev).astype(f32),
            sqrt_one_minus_alpha_prev=np.sqrt(1.0 - alpha_prev).astype(f32),
        )


def scale_model_input(state: SchedulerState, sample: torch.Tensor, i: int) -> torch.Tensor:
    """x_t scaling before the UNet call (identity for ddim)."""
    return sample * float(state.input_scales[i])


def step_ddim(state: SchedulerState, model_output: torch.Tensor, i: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step (eta = 0), in fp32."""
    model_output = model_output.float()
    sample = sample.float()
    sa = float(state.sqrt_alpha_t[i])
    soma = float(state.sqrt_one_minus_alpha_t[i])
    if state.prediction_type == "epsilon":
        x0 = (sample - soma * model_output) / sa
        eps = model_output
    else:  # v_prediction
        x0 = sa * sample - soma * model_output
        eps = sa * model_output + soma * sample
    return float(state.sqrt_alpha_prev[i]) * x0 + float(state.sqrt_one_minus_alpha_prev[i]) * eps


def create_noise_scheduler(
    scheduler_name: str = "ddim", prediction_type: str = "epsilon"
) -> NoiseScheduler:
    """Name -> scheduler factory (reference: model_util.py:230-278)."""
    return NoiseScheduler(kind=scheduler_name, prediction_type=prediction_type)
