"""The operand roundings of the reference: float32 as it is, bfloat16 (the
precision the configurations state, for a witness that reads what rounding
alone does to a seed), and the control's float8 (e4m3, one scale per tensor
at its largest magnitude, as fp8 training scales a tensor), rounded in the
forward and passed straight through in the backward."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp32(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    rounded = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (rounded - t).detach()


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


ROUNDINGS = {"fp32": fp32, "bf16": bf16, "fp8": fp8}
