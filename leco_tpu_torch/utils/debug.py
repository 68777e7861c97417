"""Pre-loop sanity checks (reference: debug_util.py).

Counterpart of `leco_tpu/utils/debug.py`: summaries of the trainable (LoRA)
and frozen parameters of a model."""

from __future__ import annotations

import torch


def check_trainable_params(model: torch.nn.Module) -> dict:
    """Print and return a summary of the parameters that require grad."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    summary = {
        "trainable tensors": len(named),
        "trainable params": sum(p.numel() for _, p in named),
        "lora layers": len({n.rsplit(".", 1)[0] for n, _ in named}),
        "dtypes": sorted({str(p.dtype).removeprefix("torch.") for _, p in named}),
    }
    print("[leco-tpu-torch] trainable:", summary)
    return summary


def check_frozen_params(model: torch.nn.Module) -> dict:
    frozen = [p for p in model.parameters() if not p.requires_grad]
    summary = {
        "frozen tensors": len(frozen),
        "frozen params": sum(p.numel() for p in frozen),
    }
    print("[leco-tpu-torch] frozen:", summary)
    return summary
