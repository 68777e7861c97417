"""CLIP text encoders for SD 1.x / 2.x as `nn.Module`s.

Counterpart of `leco_tpu/models/clip.py` (the HF `CLIPTextModel` the
reference loads, model_util.py:44-66). Parameter names are HF's
(`text_model.embeddings.token_embedding.weight`,
`text_model.encoder.layers.{i}.self_attn.q_proj.weight`, ...,
`text_projection.weight`), so a diffusers `text_encoder/` state_dict loads
as it is. The numerics follow the JAX package:

  * the activation is `quick_gelu` (x·sigmoid(1.702x), SD1) or the exact
    erf `gelu` (SD2);
  * every LayerNorm computes in fp32 and casts back to the compute dtype;
  * the causal mask fills with `finfo(float32).min` on fp32 logits, and the
    softmax runs in fp32;
  * `forward` returns (last_hidden_state after the final LayerNorm, pooled,
    hidden_states) with hidden_states in HF order: [0] the embeddings, [i]
    the output of layer i before the final LayerNorm;
  * pooled is the final-LN state at the first `eos_token_id`, projected by
    `text_projection` where the config has one.

The SD2 tower is the reference's clip-skip arithmetic expressed as a layer
count: 23 of OpenCLIP's 24 layers, then the final LayerNorm. SDXL's second
tower (`sdxl_text2_config`) is bigG with its projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (SD1) or "gelu" (SD2, SDXL's bigG)
    projection_dim: Optional[int] = None  # set for SDXL's text_encoder_2
    eos_token_id: int = 49407


def sd1_text_config(num_hidden_layers: int = 12) -> CLIPTextConfig:
    return CLIPTextConfig(num_hidden_layers=num_hidden_layers)


def sd2_text_config(num_hidden_layers: int = 23) -> CLIPTextConfig:
    """SD2.x: OpenCLIP ViT-H's text tower up to the penultimate layer."""
    return CLIPTextConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=16,
        hidden_act="gelu",
    )


def sdxl_text2_config() -> CLIPTextConfig:
    """SDXL's text_encoder_2: OpenCLIP ViT-bigG's text tower, all 32 layers,
    with its 1280-wide projection (the pooled embedding). SDXL's sequence
    embedding is `hidden_states[-2]`, the output of layer 31 before the
    final LayerNorm."""
    return CLIPTextConfig(
        hidden_size=1280,
        intermediate_size=5120,
        num_hidden_layers=32,
        num_attention_heads=20,
        hidden_act="gelu",
        projection_dim=1280,
    )


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class LayerNorm(nn.LayerNorm):
    """fp32 statistics and parameters; the result in the input's dtype."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, mask):
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = (p(x).reshape(b, n, self.heads, d) for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q * d**-0.5, k).float()
        if mask is not None:  # the vision tower attends without a mask
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids, input_embeds=None):
        """`input_embeds` (B, N, hidden), cast to the token table's dtype,
        replaces the token lookup."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        if input_embeds is None:
            tok = self.token_embedding(input_ids)
        else:
            tok = input_embeds.to(self.token_embedding.weight.dtype)
        return tok + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """forward(input_ids (B, N) int, input_embeds=None) -> (last_hidden_state,
    pooled, hidden_states), in the dtype of the parameters. `input_embeds`
    (B, N, hidden) replaces the token-embedding lookup (textual inversion
    trains vectors in that space), cast to the table's dtype; `input_ids`
    still gives the EOS pooling position."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        self.text_projection = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False)
            if config.projection_dim is not None else None
        )

    def forward(self, input_ids: torch.Tensor, input_embeds: Optional[torch.Tensor] = None):
        tm = self.text_model
        n = input_ids.shape[1]
        x = tm.embeddings(input_ids, input_embeds)
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            hidden_states.append(x)
        last = tm.final_layer_norm(x)
        # the first occurrence of eos_token_id (HF >= 4.25)
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(input_ids.shape[0], device=x.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return last, pooled, hidden_states
