"""Quantitative evaluation: the erased-concept CLIP-score delta.

Counterpart of `leco_tpu/eval.py`. Images are generated for a prompt with
the concept, with the LoRA off (multiplier 0) and on (+1 for an erase
LoRA), each batch is scored against the concept text with CLIP, and the
drop is reported. `CLIPScorer` loads a local CLIP dual-encoder directory
(config.json with `text_config` / `vision_config`, the weights, and the
tokenizer files; e.g. openai/clip-vit-large-patch14), offline.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from leco_tpu_torch.models import loader
from leco_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from leco_tpu_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModel,
    clip_score,
    preprocess_images,
)
from leco_tpu_torch.models.tokenizer import CLIPTokenizer


@dataclasses.dataclass
class CLIPScorer:
    """A CLIP dual-encoder scorer loaded from a local checkpoint dir."""

    tokenizer: CLIPTokenizer
    text_model: CLIPTextModel
    vision_model: CLIPVisionModel
    image_size: int
    device: torch.device

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cuda") -> "CLIPScorer":
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        tcfg = cfg.get("text_config", cfg)
        vcfg = cfg.get("vision_config", cfg)
        text_config = CLIPTextConfig(
            vocab_size=tcfg.get("vocab_size", 49408),
            hidden_size=tcfg.get("hidden_size", 768),
            intermediate_size=tcfg.get("intermediate_size", 3072),
            num_hidden_layers=tcfg.get("num_hidden_layers", 12),
            num_attention_heads=tcfg.get("num_attention_heads", 12),
            hidden_act=tcfg.get("hidden_act", "quick_gelu"),
            projection_dim=cfg.get("projection_dim", 768),
            eos_token_id=tcfg.get("eos_token_id", 49407),
        )
        vision_config = CLIPVisionConfig(
            hidden_size=vcfg.get("hidden_size", 1024),
            intermediate_size=vcfg.get("intermediate_size", 4096),
            num_hidden_layers=vcfg.get("num_hidden_layers", 24),
            num_attention_heads=vcfg.get("num_attention_heads", 16),
            image_size=vcfg.get("image_size", 224),
            patch_size=vcfg.get("patch_size", 14),
            projection_dim=cfg.get("projection_dim", 768),
            hidden_act=vcfg.get("hidden_act", "quick_gelu"),
        )
        device = torch.device(device)
        sd = loader.load_component_tensors(path)
        return cls(
            tokenizer=CLIPTokenizer.from_pretrained(path),
            text_model=loader.build_text_encoder(text_config, sd, dtype, device),
            vision_model=loader.build_clip_vision(vision_config, sd, dtype, device),
            image_size=vision_config.image_size,
            device=device,
        )

    @torch.no_grad()
    def text_embeds(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenizer(list(texts)).astype("int64")).to(self.device)
        _, pooled, _ = self.text_model(ids)
        return pooled

    @torch.no_grad()
    def image_embeds(self, images) -> torch.Tensor:
        return self.vision_model(preprocess_images(images, self.image_size, self.device))

    def score(self, images, texts: Sequence[str]) -> np.ndarray:
        """The CLIP score of each image against its text (one text is
        broadcast over the images)."""
        ie = self.image_embeds(images)
        te = self.text_embeds(texts)
        if te.shape[0] == 1 and ie.shape[0] > 1:
            te = te.expand(ie.shape[0], -1)
        return clip_score(ie, te).float().cpu().numpy()


def erased_concept_delta(
    scorer,
    decode_fn,
    generate_fn,
    concept: str,
    prompts: Optional[Sequence[str]] = None,
    seeds: Sequence[int] = (0, 1, 2, 3),
    multiplier: float = 1.0,
) -> dict:
    """The erased-concept CLIP-score delta over `prompts` (default: the
    concept) and `seeds`. generate_fn(prompt, seed, multiplier) -> latents;
    decode_fn(latents) -> uint8 images; scorer.score(images, [concept]).
    -> {"base": mean score at multiplier 0, "erased": at `multiplier`,
    "delta": base - erased}; a positive delta means the concept became less
    present."""
    prompts = list(prompts) if prompts else [concept]
    base_scores, erased_scores = [], []
    for prompt in prompts:
        for seed in seeds:
            img_base = decode_fn(generate_fn(prompt, seed, 0.0))
            img_erased = decode_fn(generate_fn(prompt, seed, multiplier))
            base_scores.append(scorer.score(img_base, [concept]).mean())
            erased_scores.append(scorer.score(img_erased, [concept]).mean())
    base = float(np.mean(base_scores))
    erased = float(np.mean(erased_scores))
    return {"base": base, "erased": erased, "delta": base - erased}
