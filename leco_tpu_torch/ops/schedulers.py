"""Noise schedulers (DDIM, DDPM, LMS, Euler-ancestral): numpy tables built
host-side, torch step functions.

Counterpart of `leco_tpu/ops/schedulers.py`. The beta schedule
(scaled_linear over [0.00085, 0.012], 1000 train timesteps) and the
per-inference-step gather tables are computed in float64 numpy at
`set_timesteps` time, exactly as the JAX package does, and stored as
float32: "leading" integer timesteps for DDIM/DDPM (with DDPM's posterior
mean coefficients and std), float "linspace" timesteps with interpolated
sigmas for LMS/Euler-ancestral (`input_scales` = 1/sqrt(sigma^2 + 1),
`init_noise_sigma` the largest sigma, LMS's exact Adams-Bashforth
coefficient table, Euler-a's sigma_up/sigma_down). The steps are torch, in
fp32; the stochastic ones (ddpm, euler_a) take their noise as an argument
(the diffusion loop draws it), and LMS carries its derivative history.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BETA_START = 0.00085
BETA_END = 0.012
NUM_TRAIN_TIMESTEPS = 1000
LMS_ORDER = 4

AVAILABLE_SCHEDULERS = ("ddim", "ddpm", "lms", "euler_a")


def _alphas_cumprod(num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """scaled_linear beta schedule -> cumulative alpha products (float64)."""
    betas = (
        np.linspace(
            BETA_START**0.5, BETA_END**0.5, num_train_timesteps, dtype=np.float64
        )
        ** 2
    )
    return np.cumprod(1.0 - betas)


def _empty() -> np.ndarray:
    return np.zeros((0,), np.float32)


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Per-inference-schedule float32 tables, indexed by the step index.
    Tables a kind does not use are empty."""

    kind: str
    prediction_type: str
    num_inference_steps: int
    timesteps: np.ndarray  # the value fed to the UNet's timestep embedding
    input_scales: np.ndarray  # x_t scale of scale_model_input
    init_noise_sigma: float
    # ddim / ddpm
    sqrt_alpha_t: np.ndarray = dataclasses.field(default_factory=_empty)
    sqrt_one_minus_alpha_t: np.ndarray = dataclasses.field(default_factory=_empty)
    sqrt_alpha_prev: np.ndarray = dataclasses.field(default_factory=_empty)
    sqrt_one_minus_alpha_prev: np.ndarray = dataclasses.field(default_factory=_empty)
    # ddpm posterior
    ddpm_x0_coef: np.ndarray = dataclasses.field(default_factory=_empty)
    ddpm_xt_coef: np.ndarray = dataclasses.field(default_factory=_empty)
    ddpm_std: np.ndarray = dataclasses.field(default_factory=_empty)
    # sigma space (lms / euler_a); sigmas has n + 1 entries, the last 0
    sigmas: np.ndarray = dataclasses.field(default_factory=_empty)
    lms_coeffs: np.ndarray = dataclasses.field(default_factory=_empty)
    euler_sigma_down: np.ndarray = dataclasses.field(default_factory=_empty)
    euler_sigma_up: np.ndarray = dataclasses.field(default_factory=_empty)


def _lms_coefficient_table(sigmas: np.ndarray, order: int = LMS_ORDER) -> np.ndarray:
    """Exact LMS coefficients: coeffs[i, j] multiplies the j-th most recent
    derivative at step i; the Lagrange basis over the last k sigmas (a
    polynomial of degree k - 1 <= 3) integrated exactly from sigmas[i] to
    sigmas[i + 1]."""
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)
    for i in range(n):
        k = min(i + 1, order)
        for j in range(k):
            num = np.poly1d([1.0])
            denom = 1.0
            for m in range(k):
                if m == j:
                    continue
                num = num * np.poly1d([1.0, -sigmas[i - m]])
                denom *= sigmas[i - j] - sigmas[i - m]
            anti = np.polyint(num / denom)
            coeffs[i, j] = anti(sigmas[i + 1]) - anti(sigmas[i])
    return coeffs


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
        f32 = np.float32
        meta = dict(kind=self.kind, prediction_type=self.prediction_type,
                    num_inference_steps=n)

        if self.kind in ("ddim", "ddpm"):
            # "leading" spacing (diffusers default for DDIM/DDPM)
            step_ratio = T // n
            timesteps = (np.arange(n) * step_ratio).round()[::-1].astype(np.int64)
            prev_timesteps = timesteps - step_ratio
            alpha_t = acp[timesteps]
            alpha_prev = np.where(
                prev_timesteps >= 0, acp[np.clip(prev_timesteps, 0, T - 1)], 1.0
            )
            ddpm = {}
            if self.kind == "ddpm":
                beta_cur = 1.0 - alpha_t / alpha_prev
                alpha_cur = alpha_t / alpha_prev
                var = np.clip((1.0 - alpha_prev) / (1.0 - alpha_t) * beta_cur, 1e-20, None)
                ddpm = dict(
                    ddpm_x0_coef=(np.sqrt(alpha_prev) * beta_cur / (1.0 - alpha_t)).astype(f32),
                    ddpm_xt_coef=(np.sqrt(alpha_cur) * (1.0 - alpha_prev)
                                  / (1.0 - alpha_t)).astype(f32),
                    ddpm_std=np.where(timesteps > 0, np.sqrt(var), 0.0).astype(f32),
                )
            return SchedulerState(
                **meta,
                timesteps=timesteps.astype(f32),
                input_scales=np.ones((n,), f32),
                init_noise_sigma=1.0,
                sqrt_alpha_t=np.sqrt(alpha_t).astype(f32),
                sqrt_one_minus_alpha_t=np.sqrt(1.0 - alpha_t).astype(f32),
                sqrt_alpha_prev=np.sqrt(alpha_prev).astype(f32),
                sqrt_one_minus_alpha_prev=np.sqrt(1.0 - alpha_prev).astype(f32),
                **ddpm,
            )

        # sigma-space schedulers: float "linspace" timesteps
        sigmas_full = np.sqrt((1.0 - acp) / acp)
        timesteps = np.linspace(0, T - 1, n, dtype=np.float64)[::-1].copy()
        sigmas = np.concatenate([np.interp(timesteps, np.arange(T), sigmas_full), [0.0]])
        if self.kind == "lms":
            extra = dict(lms_coeffs=_lms_coefficient_table(sigmas).astype(f32))
        else:  # euler_a
            s_from, s_to = sigmas[:-1], sigmas[1:]
            sigma_up = np.sqrt(np.clip(
                s_to**2 * (s_from**2 - s_to**2) / np.maximum(s_from**2, 1e-20), 0, None))
            extra = dict(
                euler_sigma_down=np.sqrt(np.clip(s_to**2 - sigma_up**2, 0, None)).astype(f32),
                euler_sigma_up=sigma_up.astype(f32),
            )
        return SchedulerState(
            **meta,
            timesteps=timesteps.astype(f32),
            input_scales=(1.0 / np.sqrt(sigmas[:-1] ** 2 + 1.0)).astype(f32),
            # "linspace" spacing: init_noise_sigma is the largest sigma
            init_noise_sigma=float(f32(sigmas.max())),
            sigmas=sigmas.astype(f32),
            **extra,
        )


def scale_model_input(state: SchedulerState, sample: torch.Tensor, i: int) -> torch.Tensor:
    """x_t scaling before the UNet call (identity for ddim/ddpm,
    x / sqrt(sigma^2 + 1) for lms/euler_a)."""
    return sample * float(state.input_scales[i])


def _pred_x0_alpha_space(state: SchedulerState, model_output, sample, i: int):
    """(pred_x0, pred_eps) for the alpha-space schedulers (ddim, ddpm)."""
    sa = float(state.sqrt_alpha_t[i])
    soma = float(state.sqrt_one_minus_alpha_t[i])
    if state.prediction_type == "epsilon":
        return (sample - soma * model_output) / sa, model_output
    # v_prediction
    return sa * sample - soma * model_output, sa * model_output + soma * sample


def _pred_x0_sigma_space(state: SchedulerState, model_output, sample, i: int):
    """pred_x0 for the sigma-space schedulers (`sample` is the unscaled x_t)."""
    sigma = state.sigmas[i]
    if state.prediction_type == "epsilon":
        return sample - float(sigma) * model_output
    # v_prediction: the scalars in float32, as the JAX package computes them
    one = np.float32(1)
    c_out = float(-sigma / np.sqrt(sigma**2 + one))
    return model_output * c_out + sample / float(sigma**2 + one)


def step_ddim(state: SchedulerState, model_output: torch.Tensor, i: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step (eta = 0), in fp32."""
    x0, eps = _pred_x0_alpha_space(state, model_output.float(), sample.float(), i)
    return float(state.sqrt_alpha_prev[i]) * x0 + float(state.sqrt_one_minus_alpha_prev[i]) * eps


def step_ddpm(state: SchedulerState, model_output: torch.Tensor, i: int,
              sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One DDPM step: the posterior mean from pred_x0 and x_t plus
    std * `noise` (a standard normal of the sample's shape)."""
    sample = sample.float()
    x0, _ = _pred_x0_alpha_space(state, model_output.float(), sample, i)
    mean = float(state.ddpm_x0_coef[i]) * x0 + float(state.ddpm_xt_coef[i]) * sample
    return mean + float(state.ddpm_std[i]) * noise.float()


def step_euler_a(state: SchedulerState, model_output: torch.Tensor, i: int,
                 sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One Euler-ancestral step: to sigma_down along the derivative, plus
    sigma_up * `noise`."""
    sample = sample.float()
    sigma = state.sigmas[i]
    x0 = _pred_x0_sigma_space(state, model_output.float(), sample, i)
    derivative = (sample - x0) / float(sigma)
    prev = sample + derivative * float(state.euler_sigma_down[i] - sigma)
    return prev + noise.float() * float(state.euler_sigma_up[i])


def step_lms(state: SchedulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor,
             derivative_history: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LMS step. `derivative_history` is (LMS_ORDER, *sample.shape),
    newest first (zeros before the first step) -> (prev_sample, history)."""
    sample = sample.float()
    x0 = _pred_x0_sigma_space(state, model_output.float(), sample, i)
    derivative = (sample - x0) / float(state.sigmas[i])
    history = torch.cat([derivative[None], derivative_history[:-1]], dim=0)
    coeffs = torch.from_numpy(state.lms_coeffs[i]).to(sample.device)
    return sample + torch.tensordot(coeffs, history, dims=1), history


def needs_noise(kind: str) -> bool:
    return kind in ("ddpm", "euler_a")


def create_noise_scheduler(
    scheduler_name: str = "ddim", prediction_type: str = "epsilon"
) -> NoiseScheduler:
    """Name -> scheduler factory (reference: model_util.py:230-278)."""
    return NoiseScheduler(kind=scheduler_name, prediction_type=prediction_type)
