"""Key remaps between checkpoint layouts and the port's modules.

`flax_unet_to_torch(params)` takes the JAX package's UNet parameter tree as
nested dicts of numpy arrays (LoRA leaves included; the caller passes
`np.asarray` leaves, so no JAX is needed here) and returns the port's
`state_dict`: diffusers names, torch layouts.

The LDM single-file remaps are the JAX package's (`leco_tpu/models/
convert.py`, the reference's `from_single_file`), on torch tensors and keys
only: the port's UNet already has diffusers names and torch layouts, so the
flax layout step has no counterpart here.

  * `ldm_unet_to_diffusers`: `model.diffusion_model.*` -> diffusers UNet
    keys (SD1.x/2.x; levels and attention presence read off the keys);
  * `ldm_clip_to_hf`: SD1's embedded HF CLIP (`cond_stage_model.transformer.*`;
    SDXL's CLIP-L under `conditioner.embedders.0.transformer.*`);
  * `ldm_openclip_to_hf`: SD2's OpenCLIP tower (`cond_stage_model.model.*`;
    SDXL's bigG under `conditioner.embedders.1.model.*`), with each fused
    `in_proj` split into q, k and v. All resblocks come out; the loader
    keeps the first `num_hidden_layers` (23 for SD2, all 32 for bigG).

SDXL's UNet (3 levels, `label_emb.0.{0,2}` for the added embedding) takes
the same UNet remap: the level count is read off the keys.

`diffusers_unet_to_ldm` and `hf_clip_to_openclip` are their inverses, for
writing a single-file checkpoint (`leco_tpu_torch.testing`).

`vae_decoder_state` keeps the decoder half of a diffusers AutoencoderKL
state dict with the legacy attention names (query/key/value/proj_attn,
1x1-conv shaped) renamed, as the JAX package's `torch_vae_decoder_to_flax`
reads them. `flax_vae_decoder_to_torch` and `flax_clip_vision_to_torch`
carry the JAX package's VAE decoder and CLIP vision trees to the port's
state dicts, as `flax_unet_to_torch` does the UNet's.
"""

from __future__ import annotations

import re
from typing import Mapping

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


# ---------------------------------------------------------------------------
# LDM single file <-> diffusers / HF keys
# ---------------------------------------------------------------------------

UNET_PREFIX = "model.diffusion_model."
LAYERS_PER_BLOCK = 2  # every SD1.x/2.x UNet
CLIP_PREFIX = "cond_stage_model.transformer."
OPENCLIP_PREFIX = "cond_stage_model.model."
XL_CLIP_PREFIX = "conditioner.embedders.0.transformer."
XL_OPENCLIP_PREFIX = "conditioner.embedders.1.model."

_LDM_FIXED = {
    "time_embed.0.weight": "time_embedding.linear_1.weight",
    "time_embed.0.bias": "time_embedding.linear_1.bias",
    "time_embed.2.weight": "time_embedding.linear_2.weight",
    "time_embed.2.bias": "time_embedding.linear_2.bias",
    "label_emb.0.0.weight": "add_embedding.linear_1.weight",
    "label_emb.0.0.bias": "add_embedding.linear_1.bias",
    "label_emb.0.2.weight": "add_embedding.linear_2.weight",
    "label_emb.0.2.bias": "add_embedding.linear_2.bias",
    "input_blocks.0.0.weight": "conv_in.weight",
    "input_blocks.0.0.bias": "conv_in.bias",
    "out.0.weight": "conv_norm_out.weight",
    "out.0.bias": "conv_norm_out.bias",
    "out.2.weight": "conv_out.weight",
    "out.2.bias": "conv_out.bias",
}
# LDM ResBlock submodule -> diffusers ResnetBlock2D submodule
_LDM_RESNET = {
    "in_layers.0": "norm1", "in_layers.2": "conv1", "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2", "out_layers.3": "conv2", "skip_connection": "conv_shortcut",
}


def _ldm_resnet(prefix_out: str, prefix_in: str) -> dict[str, str]:
    return {f"{prefix_in}.{ldm}.{leaf}": f"{prefix_out}.{diff}.{leaf}"
            for ldm, diff in _LDM_RESNET.items() for leaf in ("weight", "bias")}


def _map_attention(mapping: dict, out_prefix: str, in_prefix: str, keys) -> None:
    """Transformer2DModel keys are the same in LDM and diffusers apart from
    the prefix."""
    for k in keys:
        if k.startswith(in_prefix + "."):
            mapping[k] = out_prefix + k[len(in_prefix):]


def ldm_unet_to_diffusers(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`model.diffusion_model.*` LDM UNet keys -> diffusers UNet keys, the
    JAX package's mapping (convert.py:160-286): the level count comes from
    the highest `input_blocks` index, attention presence per block from the
    keys. Any UNet key the mapping does not cover raises."""
    sd = {k[len(UNET_PREFIX):]: v for k, v in state_dict.items() if k.startswith(UNET_PREFIX)}
    if not sd:
        raise ValueError("no model.diffusion_model.* keys found")
    layers_per_block = LAYERS_PER_BLOCK
    max_in = max(int(k.split(".")[1]) for k in sd if k.startswith("input_blocks."))
    num_blocks = (max_in + 1) // (layers_per_block + 1)

    mapping = dict(_LDM_FIXED)
    ldm_idx = 1
    for level in range(num_blocks):
        for layer in range(layers_per_block):
            mapping.update(_ldm_resnet(f"down_blocks.{level}.resnets.{layer}",
                                       f"input_blocks.{ldm_idx}.0"))
            attn_in = f"input_blocks.{ldm_idx}.1"
            if any(k.startswith(attn_in + ".") for k in sd):
                _map_attention(mapping, f"down_blocks.{level}.attentions.{layer}", attn_in, sd)
            ldm_idx += 1
        if level != num_blocks - 1:
            for leaf in ("weight", "bias"):
                mapping[f"input_blocks.{ldm_idx}.0.op.{leaf}"] = (
                    f"down_blocks.{level}.downsamplers.0.conv.{leaf}")
            ldm_idx += 1

    mapping.update(_ldm_resnet("mid_block.resnets.0", "middle_block.0"))
    _map_attention(mapping, "mid_block.attentions.0", "middle_block.1", sd)
    mapping.update(_ldm_resnet("mid_block.resnets.1", "middle_block.2"))

    # each output block: [resnet] (+ [transformer], found by its norm.weight)
    # (+ [upsample], found by its conv.weight)
    ldm_idx = 0
    for level in range(num_blocks):
        for layer in range(layers_per_block + 1):
            mapping.update(_ldm_resnet(f"up_blocks.{level}.resnets.{layer}",
                                       f"output_blocks.{ldm_idx}.0"))
            for sub in (1, 2):
                prefix = f"output_blocks.{ldm_idx}.{sub}"
                if f"{prefix}.norm.weight" in sd:
                    _map_attention(mapping, f"up_blocks.{level}.attentions.{layer}", prefix, sd)
                elif f"{prefix}.conv.weight" in sd:
                    for leaf in ("weight", "bias"):
                        mapping[f"{prefix}.conv.{leaf}"] = f"up_blocks.{level}.upsamplers.0.conv.{leaf}"
            ldm_idx += 1

    unmapped = sorted(set(sd) - set(mapping))
    if unmapped:
        shown = "\n  ".join(UNET_PREFIX + k for k in unmapped[:40])
        more = f"\n  ... and {len(unmapped) - 40} more" if len(unmapped) > 40 else ""
        raise ValueError(
            f"{len(unmapped)} UNet key(s) in this checkpoint are not covered by the "
            f"LDM->diffusers mapping (inferred num_blocks={num_blocks}, "
            f"layers_per_block={layers_per_block}); refusing to load a partial UNet. "
            f"Leftover keys:\n  {shown}{more}")
    return {diff_key: sd[ldm_key] for ldm_key, diff_key in mapping.items() if ldm_key in sd}


def diffusers_unet_to_ldm(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of `ldm_unet_to_diffusers`: diffusers UNet keys (the
    port's state_dict without LoRA leaves) -> `model.diffusion_model.*`."""
    fixed = {v: k for k, v in _LDM_FIXED.items()}
    resnet = {v: k for k, v in _LDM_RESNET.items()}
    lpb = LAYERS_PER_BLOCK
    up_has_attn = {int(k.split(".")[1]) for k in state_dict
                   if k.startswith("up_blocks.") and ".attentions." in k}
    out = {}
    for key, value in state_dict.items():
        if ".lora_" in key:
            raise ValueError(f"{key}: LoRA leaves have no LDM key")
        parts = key.split(".")
        if key in fixed:
            ldm = fixed[key]
        elif parts[0] == "mid_block":
            sub = {"resnets.0": "0", "attentions.0": "1", "resnets.1": "2"}[".".join(parts[1:3])]
            rest = parts[3:]
            if parts[1] == "resnets":
                rest = [resnet[rest[0]]] + rest[1:]
            ldm = ".".join(["middle_block", sub] + rest)
        elif parts[0] in ("down_blocks", "up_blocks"):
            level, kind, j, rest = int(parts[1]), parts[2], int(parts[3]), parts[4:]
            if parts[0] == "down_blocks":
                idx = 1 + level * (lpb + 1) + j
                if kind == "resnets":
                    ldm = f"input_blocks.{idx}.0." + ".".join([resnet[rest[0]]] + rest[1:])
                elif kind == "attentions":
                    ldm = f"input_blocks.{idx}.1." + ".".join(rest)
                else:  # downsamplers.0.conv.<leaf>
                    ldm = f"input_blocks.{1 + level * (lpb + 1) + lpb}.0.op.{rest[-1]}"
            else:
                idx = level * (lpb + 1) + j
                if kind == "resnets":
                    ldm = f"output_blocks.{idx}.0." + ".".join([resnet[rest[0]]] + rest[1:])
                elif kind == "attentions":
                    ldm = f"output_blocks.{idx}.1." + ".".join(rest)
                else:  # upsamplers.0.conv.<leaf>, after the transformer if any
                    idx = level * (lpb + 1) + lpb
                    sub = 2 if level in up_has_attn else 1
                    ldm = f"output_blocks.{idx}.{sub}.conv.{rest[-1]}"
        else:
            raise ValueError(f"{key}: not a diffusers UNet key")
        out[UNET_PREFIX + ldm] = value
    return out


def ldm_clip_to_hf(state_dict: Mapping[str, torch.Tensor],
                   prefix: str = CLIP_PREFIX) -> dict[str, torch.Tensor]:
    """An LDM-embedded HF CLIP text encoder -> bare HF CLIP keys: SD1's
    under `CLIP_PREFIX`, SDXL's CLIP-L under `XL_CLIP_PREFIX`."""
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


_OPENCLIP_LAYER = {  # resblock submodule -> HF encoder-layer submodule
    "ln_1": "layer_norm1", "ln_2": "layer_norm2", "attn.out_proj": "self_attn.out_proj",
    "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2",
}
_QKV = ("q_proj", "k_proj", "v_proj")


def ldm_openclip_to_hf(state_dict: Mapping[str, torch.Tensor],
                       prefix: str = OPENCLIP_PREFIX) -> dict[str, torch.Tensor]:
    """OpenCLIP text tower (SD2's under `OPENCLIP_PREFIX`, SDXL's bigG under
    `XL_OPENCLIP_PREFIX`) -> HF CLIP keys, each fused `in_proj` split into
    q, k and v (a third of its rows each: the tower's width, which the JAX
    package passes as `hidden_size`)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not sd:
        return {}
    hidden_size = sd["transformer.resblocks.0.attn.in_proj_weight"].shape[0] // 3
    out = {}
    if "text_projection" in sd:
        # OpenCLIP stores (width, proj) used as x @ W; HF's Linear is x @ W.T
        out["text_projection.weight"] = sd["text_projection"].T
    out["text_model.embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out["text_model.embeddings.position_embedding.weight"] = sd["positional_embedding"]
    out["text_model.final_layer_norm.weight"] = sd["ln_final.weight"]
    out["text_model.final_layer_norm.bias"] = sd["ln_final.bias"]
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        src, dst = f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}"
        for leaf in ("weight", "bias"):
            fused = sd[f"{src}.attn.in_proj_{leaf}"]
            for j, proj in enumerate(_QKV):
                out[f"{dst}.self_attn.{proj}.{leaf}"] = fused[j * hidden_size:(j + 1) * hidden_size]
            for ldm, hf in _OPENCLIP_LAYER.items():
                out[f"{dst}.{hf}.{leaf}"] = sd[f"{src}.{ldm}.{leaf}"]
        i += 1
    return out


def hf_clip_to_openclip(state_dict: Mapping[str, torch.Tensor],
                        prefix: str = OPENCLIP_PREFIX) -> dict[str, torch.Tensor]:
    """The inverse of `ldm_openclip_to_hf`: HF CLIP keys -> the OpenCLIP
    tower of a single file, under `prefix`."""
    sd = dict(state_dict)
    out = {
        "token_embedding.weight": sd.pop("text_model.embeddings.token_embedding.weight"),
        "positional_embedding": sd.pop("text_model.embeddings.position_embedding.weight"),
        "ln_final.weight": sd.pop("text_model.final_layer_norm.weight"),
        "ln_final.bias": sd.pop("text_model.final_layer_norm.bias"),
    }
    if "text_projection.weight" in sd:
        out["text_projection"] = sd.pop("text_projection.weight").T.contiguous()
    i = 0
    while f"text_model.encoder.layers.{i}.layer_norm1.weight" in sd:
        src, dst = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for leaf in ("weight", "bias"):
            out[f"{dst}.attn.in_proj_{leaf}"] = torch.cat(
                [sd.pop(f"{src}.self_attn.{p}.{leaf}") for p in _QKV])
            for ldm, hf in _OPENCLIP_LAYER.items():
                out[f"{dst}.{ldm}.{leaf}"] = sd.pop(f"{src}.{hf}.{leaf}")
        i += 1
    if sd:
        raise ValueError(f"keys with no OpenCLIP counterpart: {sorted(sd)[:10]}")
    return {prefix + k: v for k, v in out.items()}


# ---------------------------------------------------------------------------
# the VAE decoder and the CLIP vision tower
# ---------------------------------------------------------------------------

_VAE_LEGACY_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v",
                         "proj_attn": "to_out.0", "q": "to_q", "k": "to_k", "v": "to_v",
                         "proj_out": "to_out.0"}


def vae_decoder_state(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> its `post_quant_conv.*` and
    `decoder.*` tensors, the mid-block attention under the current names."""
    out = {}
    for name, t in state_dict.items():
        if not name.startswith(("post_quant_conv.", "decoder.")):
            continue
        m = re.fullmatch(r"(decoder\.mid_block\.attentions\.\d+)\.(\w+)\.(weight|bias)", name)
        if m and m[2] in _VAE_LEGACY_ATTENTION:
            name = f"{m[1]}.{_VAE_LEGACY_ATTENTION[m[2]]}.{m[3]}"
            if t.ndim == 4:  # a 1x1-conv projection
                t = t[:, :, 0, 0]
        out[name] = t
    return out


def _torch_leaf(name: str, leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        return f"{name}.weight", v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    if leaf == "scale":
        return f"{name}.weight", v
    if leaf == "bias":
        return f"{name}.bias", v
    raise KeyError(f"unknown parameter leaf {leaf} of {name}")


def flax_vae_decoder_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's VAEDecoder tree -> the port's VAEDecoder state_dict
    (`up_blocks_0_resnets_1` -> `decoder.up_blocks.0.resnets.1`,
    `to_out_0` -> `to_out.0`, `post_quant_conv` at the top)."""
    out = {}
    for path, v in _flatten(params).items():
        head, *subs, leaf = path
        m = re.fullmatch(r"(mid_block|up_blocks_(\d+))_(resnets|attentions|upsamplers)_(\d+)",
                         head)
        if head == "post_quant_conv":
            name = head
        elif m:
            block = "mid_block" if m[2] is None else f"up_blocks.{m[2]}"
            name = f"decoder.{block}.{m[3]}.{m[4]}"
        else:
            name = f"decoder.{head}"
        for sub in subs:
            name += ".to_out.0" if sub == "to_out_0" else f".{sub}"
        key, t = _torch_leaf(name, leaf, v)
        out[key] = t
    return {k: torch.tensor(v) for k, v in out.items()}


def flax_clip_vision_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's CLIPVisionModel tree -> the port's (HF-named)
    CLIPVisionModel state_dict."""
    out = {}
    emb = "vision_model.embeddings"
    for path, v in _flatten(params).items():
        if path == ("class_embedding",):
            out[f"{emb}.class_embedding"] = v
        elif path == ("patch_embedding", "kernel"):
            out[f"{emb}.patch_embedding.weight"] = v.transpose(3, 2, 0, 1)
        elif path == ("position_embedding", "embedding"):
            out[f"{emb}.position_embedding.weight"] = v
        elif path[0] == "visual_projection":
            out["visual_projection.weight"] = v.T
        elif path[0] in ("pre_layrnorm", "post_layernorm"):
            key, t = _torch_leaf(f"vision_model.{path[0]}", path[-1], v)
            out[key] = t
        else:  # ("layers_N", "self_attn", "q_proj", leaf) / ("layers_N", "mlp_fc1", leaf)
            layer = "vision_model.encoder.layers." + path[0].split("_")[1]
            mods = [m.replace("mlp_", "mlp.") for m in path[1:-1]]
            key, t = _torch_leaf(".".join([layer, *mods]), path[-1], v)
            out[key] = t
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}
