"""Prompt schema, embedding cache and the ESD erase/enhance loss.

Counterpart of `leco_tpu/prompts.py` (reference prompt_util.py in
p1atdev/LECO). `PromptSettings` is a dataclass built by `from_dict`, with
the same fields, defaults, fills (positive <- target, neutral <-
unconditional) and ignored unknown keys as the JAX package's pydantic model.
"""

import dataclasses
from pathlib import Path
from typing import Callable, Literal, Optional, Union

import torch

from leco_tpu_torch.config import _Section
from leco_tpu_torch.utils import yaml_subset

ACTION_TYPES = Literal["erase", "enhance"]


@dataclasses.dataclass
class PromptSettings(_Section):
    """One prompt entry of the prompts YAML (prompt_util.py:43-67)."""

    target: str
    positive: Optional[str] = None  # if None, target is used
    unconditional: str = ""
    neutral: Optional[str] = None  # if None, unconditional is used
    action: ACTION_TYPES = "erase"
    guidance_scale: float = 1.0
    resolution: int = 512
    dynamic_resolution: bool = False
    batch_size: int = 1
    dynamic_crops: bool = False  # only used for SDXL

    @classmethod
    def from_dict(cls, values: dict) -> "PromptSettings":
        if "target" not in values:
            raise ValueError("target must be specified")
        values = dict(values)
        values.setdefault("positive", values["target"])
        values.setdefault("unconditional", "")
        values.setdefault("neutral", values["unconditional"])
        return super().from_dict(values)


class PromptEmbedsXL:
    """SDXL's two embeddings of a prompt (prompt_util.py:17-24): the
    sequence `text_embeds` (1, 77, 2048) and the pooled `pooled_embeds`
    (1, 1280)."""

    def __init__(self, text_embeds: torch.Tensor, pooled_embeds: torch.Tensor) -> None:
        self.text_embeds = text_embeds
        self.pooled_embeds = pooled_embeds


# SD1.x/2.x cache values are tensors, SDXL's PromptEmbedsXL
PROMPT_EMBEDDING = Union[torch.Tensor, PromptEmbedsXL]


class PromptEmbedsCache:
    """Prompt string -> embedding, computed once before the train loop."""

    def __init__(self) -> None:
        self.prompts: dict[str, PROMPT_EMBEDDING] = {}

    def __setitem__(self, name: str, value: PROMPT_EMBEDDING) -> None:
        self.prompts[name] = value

    def __getitem__(self, name: str) -> Optional[PROMPT_EMBEDDING]:
        return self.prompts.get(name)


def esd_loss(
    target_latents: torch.Tensor,
    positive_latents: torch.Tensor,
    unconditional_latents: torch.Tensor,
    neutral_latents: torch.Tensor,
    guidance_scale: float,
    erase_sign: float,
) -> torch.Tensor:
    """ESD noise-prediction MSE, in fp32 whatever the model dtype.
    erase_sign = +1 for "erase" (neutral - g*(positive - uncond)), -1 for
    "enhance" (prompt_util.py:107-135)."""
    target = target_latents.float()
    positive = positive_latents.float()
    uncond = unconditional_latents.float()
    neutral = neutral_latents.float()
    goal = neutral - erase_sign * guidance_scale * (positive - uncond)
    return torch.mean((target - goal) ** 2)


class PromptEmbedsPair:
    """Cached embeddings for one prompt entry + its loss settings
    (prompt_util.py:70-148)."""

    def __init__(self, target, positive, unconditional, neutral,
                 settings: PromptSettings) -> None:
        self.target = target
        self.positive = positive
        self.unconditional = unconditional
        self.neutral = neutral

        self.guidance_scale = settings.guidance_scale
        self.resolution = settings.resolution
        self.dynamic_resolution = settings.dynamic_resolution
        self.batch_size = settings.batch_size
        self.dynamic_crops = settings.dynamic_crops
        self.action = settings.action
        self.settings = settings

    @property
    def erase_sign(self) -> float:
        if self.action == "erase":
            return 1.0
        if self.action == "enhance":
            return -1.0
        raise ValueError("action must be erase or enhance")

    def loss(self, *, target_latents, positive_latents, unconditional_latents,
             neutral_latents):
        return esd_loss(
            target_latents, positive_latents, unconditional_latents,
            neutral_latents, guidance_scale=self.guidance_scale,
            erase_sign=self.erase_sign,
        )


def load_prompts_from_yaml(path: str | Path) -> list[PromptSettings]:
    """YAML list -> [PromptSettings] (prompt_util.py:151-160), read by the
    port's own reader (`utils/yaml_subset.py`)."""
    prompts = yaml_subset.load(path)
    if not prompts:
        raise ValueError("prompts file is empty")
    return [PromptSettings.from_dict(prompt) for prompt in prompts]


def make_encode_fn(tokenizer, text_encoder: torch.nn.Module, device) -> Callable:
    """prompt -> (1, 77, d) embedding: tokenize, then the CLIP text encoder's
    final-LayerNorm last hidden state (train_util.encode_prompts,
    train_util.py:77-85; the JAX CLI's encode_fn, train_lora.py:69-74)."""

    @torch.no_grad()
    def encode(prompt: str) -> torch.Tensor:
        ids = torch.from_numpy(tokenizer([prompt]).astype("int64")).to(device)
        last, _, _ = text_encoder(ids)
        return last

    return encode


def make_encode_fn_xl(tokenizers, text_encoders, device) -> Callable:
    """prompt -> PromptEmbedsXL: per encoder the penultimate hidden state
    (`hidden_states[-2]`, before the final LayerNorm), concatenated on the
    feature dim (768 + 1280 = 2048); the pooled embedding is encoder 2's
    projected EOS state (train_util.encode_prompts_xl, train_util.py:107-130;
    the JAX CLI's encode_fn, train_lora_xl.py:58-69)."""

    @torch.no_grad()
    def encode(prompt: str) -> PromptEmbedsXL:
        seqs, pooled = [], None
        for tokenizer, text_encoder in zip(tokenizers, text_encoders):
            ids = torch.from_numpy(tokenizer([prompt]).astype("int64")).to(device)
            _, pooled, hidden = text_encoder(ids)
            seqs.append(hidden[-2])
        return PromptEmbedsXL(torch.cat(seqs, dim=-1), pooled)

    return encode


def prompt_encoder(models, device) -> Callable:
    """The prompt encoder of a loader's `LoadedModels`: `make_encode_fn_xl`
    over both tokenizers and encoders for SDXL, else `make_encode_fn`."""
    if models.is_xl:
        return make_encode_fn_xl([models.tokenizer, models.tokenizer_2],
                                 [models.text_encoder, models.text_encoder_2], device)
    return make_encode_fn(models.tokenizer, models.text_encoder, device)
