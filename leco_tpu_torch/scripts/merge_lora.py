"""Bake a trained LoRA into the base UNet weights and write the merged
diffusers UNet `.safetensors`.

    python -m leco_tpu_torch.scripts.merge_lora --model <diffusers dir> \
        --lora <name>_last.safetensors [--multiplier 1.0] --out merged_unet.safetensors \
        [--device cuda|cpu]

Counterpart of `scripts/merge_lora.py`: W' = W + up·down · (alpha / rank) ·
multiplier for each layer of the LoRA file (the A1111 / kohya merge), in
fp32, rounded once to W's dtype. The output is a diffusers-keyed UNet
state dict any SD consumer loads (and the port's loader). `--device`
defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
import os

import torch

LORA_PREFIX = "lora_unet_"


def merge_lora_into_state(state: dict[str, torch.Tensor], lora_state: dict[str, torch.Tensor],
                          multiplier: float = 1.0, device="cpu") -> dict[str, torch.Tensor]:
    """Apply every `lora_unet_<name>.*` triplet of `lora_state` to the
    matching diffusers key of `state` (both in torch layout); the merged
    weights come back on the CPU. A name resolves against the state's keys,
    since an underscore in it may have been a dot or not."""
    layers: dict[str, dict] = {}
    for key, v in lora_state.items():
        name, _, leaf = key.rpartition(".")
        if leaf == "alpha":
            layers.setdefault(name, {})["alpha"] = float(v)
            continue
        name, _, which = name.rpartition(".")
        layers.setdefault(name, {})[which] = v.to(device, torch.float32)

    by_flat = {k[: -len(".weight")].replace(".", "_"): k for k in state if k.endswith(".weight")}
    out = dict(state)
    for name, t in layers.items():
        target = by_flat.get(name[len(LORA_PREFIX):])
        if target is None:
            raise KeyError(f"cannot resolve {name} to a diffusers key")
        down, up = t["lora_down"], t["lora_up"]
        rank = down.shape[0]
        scale = t.get("alpha", float(rank)) / rank * multiplier
        w = state[target].to(device, torch.float32)
        if w.ndim == 2:
            delta = up @ down * scale
        else:  # conv: up (out, r, 1, 1) composed with down (r, in, kh, kw)
            delta = torch.einsum("or,rikh->oikh", up[:, :, 0, 0], down) * scale
            delta = delta.reshape(w.shape)
        out[target] = (w + delta).to(state[target].dtype).cpu()
    print(f"merged {len(layers)} LoRA layers")
    return out


def main(argv=None) -> None:
    from leco_tpu_torch.lora import read_safetensors, write_safetensors
    from leco_tpu_torch.models.loader import load_component_tensors
    from leco_tpu_torch.train_lora import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="diffusers dir")
    ap.add_argument("--lora", required=True)
    ap.add_argument("--multiplier", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to merge on (default cuda; no fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    state = load_component_tensors(os.path.join(args.model, "unet"))
    lora_state, _ = read_safetensors(args.lora)
    merged = merge_lora_into_state(state, lora_state, args.multiplier, device)
    write_safetensors(args.out, merged)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
