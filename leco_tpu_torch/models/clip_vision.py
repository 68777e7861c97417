"""The CLIP vision tower and the CLIP score, for the eval harness.

Counterpart of `leco_tpu/models/clip_vision.py`: a standard CLIP ViT
(ViT-L/14 by default: 24 layers, 1024 wide, 16 heads, patch 14, image 224,
projection 768) whose encoder layers are the text encoder's
`CLIPEncoderLayer`, run without a mask. Parameter names are HF's
(`vision_model.embeddings.patch_embedding.weight`,
`vision_model.pre_layrnorm.*` with HF's spelling, ...,
`visual_projection.weight`), so the vision half of a `CLIPModel` state dict
loads as it is. Images are NCHW here (the JAX package's are NHWC).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from leco_tpu_torch.models.clip import CLIPEncoder, CLIPTextConfig, LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"

    def as_text_config(self) -> CLIPTextConfig:
        """The encoder layers' config (the text tower's block structure)."""
        return CLIPTextConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            hidden_act=self.hidden_act,
        )


def tiny_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2, image_size=32, patch_size=8,
                            projection_dim=16)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size) * 0.02)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        b, _, c = patches.shape
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, c)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = CLIPEncoder(cfg.as_text_config())
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """forward(pixel_values (B, 3, S, S), normalised by `preprocess_images`)
    -> projected image embeddings (B, projection_dim), in the dtype of the
    parameters."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        dtype = self.visual_projection.weight.dtype
        x = vm.pre_layrnorm(vm.embeddings(pixel_values.to(dtype)))
        for layer in vm.encoder.layers:
            x = layer(x, None)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_images(images, image_size: int = 224, device=None) -> torch.Tensor:
    """uint8 or float images (B, H, W, 3), numpy or torch -> CLIP-normalised
    fp32 pixels (B, 3, S, S). Divided by 255 only where the maximum is over
    1.5; resized bilinearly with the antialiasing triangle filter when
    shrinking (what `jax.image.resize(..., "bilinear")` does); then
    normalised by CLIP's mean and std."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                        device=device).float()
    if x.max() > 1.5:
        x = x / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def clip_score(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of each (image, text) pair times 100, clipped at 0
    (the CLIPScore convention)."""
    ie = image_embeds / torch.linalg.norm(image_embeds, dim=-1, keepdim=True)
    te = text_embeds / torch.linalg.norm(text_embeds, dim=-1, keepdim=True)
    return torch.clamp((ie * te).sum(dim=-1), min=0.0) * 100.0
