"""Inference: text-to-image with an optional LoRA, the A/B grid, decoding.

Counterpart of `leco_tpu/infer.py` (the reference's test/infer_xl.py and the
notebook's before/after A/B, train.ipynb cells 11-12), SD1.x/2.x and SDXL.
SDXL encodes with both towers (`hidden_states[-2]` of each, concatenated;
the pooled embedding of the second) and conditions every UNet call on the
pooled (uncond, cond) pair and the `time_ids` of (height, width). A LoRA
enters at the AddNet weight `multiplier` by scaling its `lora_up` leaves
(exact: the contribution is linear in them), as in the reference README's
X/Y/Z AddNet-weight grid. How a call runs the UNet's LoRA layers
(`applied_lora`), mirroring the JAX package's choice of parameter tree:

  * one tree at a non-zero multiplier: the branch on, `lora_up` scaled;
  * no LoRA, or multiplier 0: every branch off (the base weights alone, so
    a c3lier upsampler takes its phase convolutions);
  * a list of (tree, multiplier) pairs: all folded into the base weights
    with `compose_lora_params` (needs the spec for alpha / rank).

The weights the model held before a call are what it holds after it.
Randomness comes from three torch generators derived from `seed` (the
latents, the offset noise and the scheduler's noise; the JAX package splits
one key in three), so a seed gives the same image on one device, but not
the JAX package's image. The denoise is the trainer's `diffusion()` loop
over every step of the schedule (`denoise`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from leco_tpu_torch.lora import (
    LoRASpec,
    compose_lora_params,
    lora_layers,
    scale_lora_tree,
)
from leco_tpu_torch.models.loader import LoadedModels
from leco_tpu_torch.ops import schedulers as sched
from leco_tpu_torch.prompts import prompt_encoder
from leco_tpu_torch.train import diffusion as diff


@dataclasses.dataclass
class GenerationConfig:
    height: int = 512
    width: int = 512
    num_inference_steps: int = 20
    guidance_scale: float = 7.0
    seed: int = 0
    noise_offset: float = 0.0  # the SDXL smoke script used 0.0357 (infer_xl.py:26)


@contextlib.contextmanager
def applied_lora(unet: torch.nn.Module, lora=None, multiplier: float = 1.0,
                 spec: Optional[LoRASpec] = None):
    """Run the UNet's LoRA layers with `lora` inside the block (see the
    module docstring); every layer's weights and mode are restored after."""
    layers = dict(lora_layers(unet))
    saved = {n: (m.mode, m.folded, m.lora_down.data, m.lora_up.data)
             for n, m in layers.items()}
    try:
        with torch.no_grad():
            if isinstance(lora, (list, tuple)):
                if spec is None:
                    raise ValueError("multi-LoRA composition requires spec=LoRASpec(...)")
                base = {f"{n}.weight": m.weight for n, m in layers.items()}
                device = next(iter(base.values())).device if base else None
                trees = [({k: v.to(device) for k, v in tree.items()}, mult)
                         for tree, mult in lora]
                folded = compose_lora_params(base, trees, spec)
                for n, m in layers.items():
                    m.folded, m.mode = folded[f"{n}.weight"], "folded"
            elif lora is not None and multiplier != 0.0:
                unknown = {k.rsplit(".", 1)[0] for k in lora} - layers.keys()
                if unknown:
                    raise KeyError(f"{len(unknown)} LoRA layer(s) the model has no branch for "
                                   f"(load it with its lora_spec): {sorted(unknown)[:5]}")
                tree = scale_lora_tree(lora, multiplier)
                for n, m in layers.items():
                    if f"{n}.lora_down" not in tree:
                        m.mode = "off"
                        continue
                    m.lora_down.data = tree[f"{n}.lora_down"].to(m.lora_down.data)
                    m.lora_up.data = tree[f"{n}.lora_up"].to(m.lora_up.data)
                    m.mode = "on"
            else:
                for m in layers.values():
                    m.mode = "off"
        yield
    finally:
        for n, (mode, folded, down, up) in saved.items():
            m = layers[n]
            m.mode, m.folded = mode, folded
            m.lora_down.data, m.lora_up.data = down, up


def denoise(unet, state: sched.SchedulerState, latents: torch.Tensor,
            text_embeddings: torch.Tensor, guidance_scale: float,
            noise=None, added_cond_kwargs: Optional[dict] = None) -> torch.Tensor:
    """Every step of `state`'s schedule from `latents` at CFG
    `guidance_scale` over the packed (uncond, cond) `text_embeddings` (the
    JAX package's runner, `_get_runner`'s `run`). `noise(i)` is step i's
    standard normal, for the stochastic schedulers; `added_cond_kwargs`
    SDXL's conditioning of the packed batch."""
    return diff.diffusion(unet, state, latents, text_embeddings, state.num_inference_steps,
                          guidance_scale=guidance_scale, noise=noise,
                          added_cond_kwargs=added_cond_kwargs)


def _device(models: LoadedModels) -> torch.device:
    return next(models.unet.parameters()).device


def _encode(models: LoadedModels, prompt: str):
    """(1, 77, d) for SD1.x/2.x; PromptEmbedsXL for SDXL: the CLIs' prompt
    encoders (`prompts.prompt_encoder`)."""
    return prompt_encoder(models, _device(models))(prompt)


def _generators(seed: int, device) -> list[torch.Generator]:
    """Three independent generators from one seed: latents, offset noise,
    scheduler noise."""
    out = []
    for child in np.random.SeedSequence(seed).spawn(3):
        g = torch.Generator(device)
        g.manual_seed(int(child.generate_state(1)[0]))
        out.append(g)
    return out


@torch.no_grad()
def generate_latents(
    models: LoadedModels,
    prompt: str,
    negative_prompt: str = "",
    gen: GenerationConfig = GenerationConfig(),
    lora=None,
    multiplier: float = 1.0,
    spec: Optional[LoRASpec] = None,
    positive_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The full text-to-image denoise -> final latents (1, 4, h/8, w/8),
    fp32, on the model's device.

    `lora` is one LoRA tree (applied at `multiplier`) or a list of
    (tree, multiplier) pairs, the multi-AddNet composition, which needs
    `spec`. `positive_embeds` (1, 77, d) replaces the positive prompt's
    encoding (how a textual-inversion embedding enters inference)."""
    if positive_embeds is not None and models.is_xl:
        raise ValueError("positive_embeds targets SD1.x/2.x inference")
    device = _device(models)
    state = models.scheduler.set_timesteps(gen.num_inference_steps)
    pos = _encode(models, prompt)
    neg = _encode(models, negative_prompt)
    added = None
    if models.is_xl:
        # (uncond, cond) order for CFG chunking (train_util.py:133-138)
        text_embeddings = torch.cat([neg.text_embeds, pos.text_embeds], dim=0)
        time_ids = torch.from_numpy(diff.get_add_time_ids(gen.height, gen.width)).to(device)
        added = {"text_embeds": torch.cat([neg.pooled_embeds, pos.pooled_embeds], dim=0),
                 "time_ids": time_ids.repeat(2, 1)}
    else:
        if positive_embeds is not None:
            pos = torch.as_tensor(positive_embeds, device=device).to(pos.dtype)
        text_embeddings = torch.cat([neg, pos], dim=0)  # (uncond, cond) for CFG

    g_lat, g_off, g_sched = _generators(gen.seed, device)
    latents = diff.get_initial_latents(g_lat, state, 1, gen.height, gen.width, device)
    if gen.noise_offset:
        latents = diff.apply_noise_offset(g_off, latents, gen.noise_offset)
    noise = None
    if sched.needs_noise(state.kind):
        def noise(i: int) -> torch.Tensor:
            return torch.randn(latents.shape, generator=g_sched, device=device,
                               dtype=torch.float32)
    with applied_lora(models.unet, lora, multiplier, spec):
        return denoise(models.unet, state, latents, text_embeddings, gen.guidance_scale, noise,
                       added)


@torch.no_grad()
def decode_latents(models: Optional[LoadedModels], latents: torch.Tensor,
                   vae=None) -> np.ndarray:
    """latents -> uint8 images (B, H, W, 3) through the VAE decoder
    (test/infer_xl.py:136-153): latents / scaling_factor, decode, then
    round(clip(x / 2 + 0.5, 0, 1) · 255) in fp32, half to even."""
    if vae is None:
        raise ValueError("pass vae=VAEDecoder(...) (load it with "
                         "leco_tpu_torch.models.loader.load_vae_decoder)")
    images = vae(latents / vae.config.scaling_factor).float().permute(0, 2, 3, 1)
    images = torch.clamp(images / 2 + 0.5, 0.0, 1.0)
    return (images * 255).round().to(torch.uint8).cpu().numpy()


def encode_png(image: np.ndarray) -> bytes:
    """A uint8 RGB image (H, W, 3) as PNG bytes: 8-bit truecolour, no
    interlace, every row with filter 0, one zlib IDAT."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_images(images: np.ndarray, prefix: str = "output") -> list[str]:
    """Each uint8 image of the batch to `<prefix>_<i>.png`; -> the paths."""
    paths = []
    for i, img in enumerate(images):
        p = f"{prefix}_{i}.png"
        with open(p, "wb") as f:
            f.write(encode_png(img))
        paths.append(p)
    return paths


def ab_compare(
    models: LoadedModels,
    lora: dict,
    prompt: str,
    negative_prompt: str = "",
    multipliers: tuple = (-1.0, 0.0, 1.0),
    gen: GenerationConfig = GenerationConfig(),
) -> dict[float, torch.Tensor]:
    """The notebook's A/B protocol as the AddNet-weight grid: the same seed,
    one latents batch per multiplier."""
    return {m: generate_latents(models, prompt, negative_prompt, gen, lora=lora, multiplier=m)
            for m in multipliers}
