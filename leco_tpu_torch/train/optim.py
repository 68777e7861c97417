"""Optimizer + LR-schedule factories.

Counterpart of `leco_tpu/train/optim.py` (reference train_util.py:333-401).
Ported so far: AdamW, mapped as the JAX package maps it (eps 1e-8,
weight_decay 0.01, betas (0.9, 0.999), optimizer_args override them), and
the constant LR schedule. Every other name raises NotImplementedError and is
queued in ROADMAP.md.
"""

from __future__ import annotations

import ast
from typing import Callable, Iterable, Optional

import torch


def parse_optimizer_args(optimizer_args: str) -> dict:
    """'k1=v1 k2=v2' -> dict via ast.literal_eval (train_lora.py:82-89)."""
    kwargs = {}
    if optimizer_args:
        for arg in optimizer_args.split(" "):
            if not arg:
                continue
            key, value = arg.split("=")
            kwargs[key] = ast.literal_eval(value)
    return kwargs


def get_lr_schedule(name: Optional[str], lr: float,
                    max_iterations: Optional[int]) -> Callable[[int], float]:
    """Schedule fn(step) -> lr."""
    if name == "constant" or name is None:
        return lambda step: lr
    if name in ("cosine", "cosine_with_restarts", "step", "linear"):
        raise NotImplementedError(f"lr scheduler {name} is not ported yet")
    raise ValueError(
        "Scheduler must be cosine, cosine_with_restarts, step, linear or constant"
    )


def get_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                  optimizer_args: str = "") -> torch.optim.Optimizer:
    """Name -> torch optimizer over `params` (train_util.py:333-370)."""
    name = name.lower()
    kwargs = parse_optimizer_args(optimizer_args)
    if name == "adamw":
        kwargs.setdefault("eps", 1e-8)
        kwargs.setdefault("weight_decay", 0.01)  # torch AdamW default
        kwargs.setdefault("betas", (0.9, 0.999))
        return torch.optim.AdamW(params, lr=lr, **kwargs)
    if name in ("adam", "adam8bit", "lion", "lion8bit", "prodigy",
                "dadaptadam", "dadaptlion"):
        raise NotImplementedError(f"optimizer {name} is not ported yet")
    raise ValueError("Optimizer must be adam, adamw, lion or Prodigy")
