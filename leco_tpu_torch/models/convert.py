"""Carry the JAX package's UNet parameters across to the port.

`flax_unet_to_torch(params)` takes the JAX package's UNet parameter tree as
nested dicts of numpy arrays (LoRA leaves included; the caller passes
`np.asarray` leaves, so no JAX is needed here) and returns the port's
`state_dict`: diffusers names, torch layouts.
"""

from __future__ import annotations

import numpy as np
import torch

# flax module names that fold a ModuleList index into the name
_INDEXED = (
    "down_blocks", "up_blocks", "attentions", "resnets", "downsamplers",
    "upsamplers", "transformer_blocks", "net", "to_out",
)


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_name(path: tuple) -> str:
    """('down_blocks_0', 'attentions_1', 'to_out_0') ->
    'down_blocks.0.attentions.1.to_out.0'."""
    parts = []
    for comp in path:
        head, _, tail = comp.rpartition("_")
        if head in _INDEXED and tail.isdigit():
            parts.extend([head, tail])
        else:
            parts.append(comp)
    return ".".join(parts)


def flax_unet_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """JAX UNet parameter tree -> the port's state_dict.

    kernel (in, out) -> weight (out, in); conv kernel (kh, kw, in, out) ->
    (out, in, kh, kw); norm scale -> weight; dense lora_down (in, r) ->
    (r, in) and lora_up (r, out) -> (out, r); conv lora_down
    (kh, kw, in, r) -> (r, in, kh, kw) and lora_up (r, out) ->
    (out, r, 1, 1)."""
    out = {}
    flat = _flatten(params)
    conv_lora = {p[:-1] for p, v in flat.items() if p[-1] == "lora_down" and v.ndim == 4}
    for path, v in flat.items():
        name = _module_name(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            t = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            out[f"{name}.weight"] = t
        elif leaf == "scale":
            out[f"{name}.weight"] = v
        elif leaf == "bias":
            out[f"{name}.bias"] = v
        elif leaf == "lora_down":
            out[f"{name}.lora_down"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        elif leaf == "lora_up":
            t = v.T
            out[f"{name}.lora_up"] = t[:, :, None, None] if path[:-1] in conv_lora else t
        else:
            raise KeyError(f"unknown parameter leaf {path}")
    return {k: torch.tensor(v) for k, v in out.items()}
