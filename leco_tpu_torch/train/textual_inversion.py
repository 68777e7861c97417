"""Textual-inversion erasure: the ESD objective trained into token embeddings.

Counterpart of `leco_tpu/train/textual_inversion.py`. The trainable is the
target prompt's own token-embedding rows (its positions between BOS and the
first EOS), held as one fp32 `nn.Parameter` (n_tokens, hidden); the UNet
and the text encoder stay frozen. The UNet runs on its base weights: load
it without LoRA layers (`lora_spec=None`), as the JAX step applies the base
parameter tree alone. One iteration, as in the JAX package:

    [no grad] encode the target with the current rows spliced in;
              t_to UNet forwards @ 2B CFG batch, guidance 3
    [no grad] 1 UNet forward @ 3B: the three references on fixed embeddings
    [grad   ] encode the target with the rows spliced in, 1 UNet forward @ B
    fp32 ESD loss -> backward through the UNet and the text encoder into the
    rows -> optimizer step at the schedule's lr

The splice casts the rows to the token table's dtype (bf16 in the CLI), as
the JAX package's `.astype(tok.dtype)` does; their gradient comes back in
fp32. The export is an A1111/webui embedding: a `.safetensors` holding one
`emb_params` tensor (n_tokens, hidden) in `save.precision`, with the
metadata `name`, `config` and `target` (drop it in webui's `embeddings/`
and use its file name in a prompt, or a negative prompt). Any other
extension is written by `torch.save`, as the port's LoRA export is.

SD1.x/2.x only: an SDXL prompt feeds two encoders, and A1111's XL
embeddings are a two-part format this module does not target.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from leco_tpu_torch.config import RootConfig, parse_precision
from leco_tpu_torch.lora import read_safetensors, write_safetensors
from leco_tpu_torch.models.clip import CLIPTextModel
from leco_tpu_torch.prompts import PromptSettings, esd_loss
from leco_tpu_torch.train import diffusion as diff
from leco_tpu_torch.train.optim import get_lr_schedule, get_optimizer
from leco_tpu_torch.train.trainer import ModelBundle, build_pack, encode_prompt_pairs


@dataclasses.dataclass
class TextEncoderHandle:
    """The text stack the TI step keeps alive (the LoRA trainer frees its
    encoder once the prompts are encoded)."""

    model: CLIPTextModel
    tokenizer: Callable  # list[str] -> (B, 77) int ids
    device: torch.device


def prompt_slots(token_ids, eos: int = 49407) -> np.ndarray:
    """The positions of the prompt's own tokens: after BOS (position 0), up
    to the first EOS, exclusive. Those rows become the trainable embedding."""
    ids = np.asarray(token_ids).reshape(-1)
    end = int(np.argmax(ids == eos))
    if end <= 1:
        raise ValueError("target prompt tokenized to zero trainable tokens")
    return np.arange(1, end)


def init_prompt_embedding(handle: TextEncoderHandle, prompt: str):
    """Tokenize `prompt` and take the token table's rows at its slots ->
    (token_ids (1, 77) int64 on the device, slots (n,), emb0 (n, hidden)
    fp32 on the device)."""
    token_ids = np.asarray(handle.tokenizer([prompt]))
    slots = prompt_slots(token_ids, handle.model.config.eos_token_id)
    table = handle.model.text_model.embeddings.token_embedding.weight
    ids = torch.from_numpy(token_ids.astype(np.int64)).to(handle.device)
    emb0 = table.detach()[ids[0, torch.from_numpy(slots).to(handle.device)]].float()
    return ids, slots, emb0


def encode_spliced(handle: TextEncoderHandle, token_ids: torch.Tensor, slots,
                   emb: torch.Tensor) -> torch.Tensor:
    """The final-LayerNorm sequence embedding (1, 77, d) of `token_ids` with
    `emb` (n, hidden) spliced into the token embeddings at `slots`: what
    A1111 does when a prompt names the embedding's file. Differentiable in
    `emb`; pass it to `infer.generate_latents(positive_embeds=...)`."""
    table = handle.model.text_model.embeddings.token_embedding.weight
    tok = table[token_ids]
    index = torch.as_tensor(np.asarray(slots), device=tok.device)
    tok = tok.index_copy(1, index, emb[None].to(tok.dtype))
    last, _, _ = handle.model(token_ids, input_embeds=tok)
    return last


def make_ti_train_step(bundle: ModelBundle, handle: TextEncoderHandle,
                       token_ids: torch.Tensor, slots, optimizer: torch.optim.Optimizer,
                       max_denoising_steps: int, inner_guidance_scale: float = 3.0):
    """-> step(emb, pack, guidance_scale, erase_sign, timesteps_to, *,
    height, width, generator=None, latents=None) -> loss (0-d fp32 tensor).
    `emb` is the parameter `optimizer` steps; `pack` holds `uncond_embeds`
    (1, 77, d) and `ref_embeds` (3B, 77, d) ([positive]*B + [neutral]*B +
    [uncond]*B). `generator` and `latents` are `trainer.make_train_step`'s.
    The optimizer steps at its `param_groups` lr, which the caller sets."""
    unet = bundle.unet
    scheduler = bundle.scheduler
    state_n = scheduler.set_timesteps(max_denoising_steps)
    state_full = scheduler.set_timesteps(scheduler.num_train_timesteps)
    num_train_timesteps = scheduler.num_train_timesteps

    def step(emb: torch.nn.Parameter, pack: dict, guidance_scale: float, erase_sign: float,
             timesteps_to: int, *, height: int, width: int,
             generator: Optional[torch.Generator] = None,
             latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = pack["ref_embeds"].shape[0] // 3
        if latents is None:
            latents = diff.get_initial_latents(
                generator, state_n, batch, height, width, bundle.device)

        def noise(i: int) -> torch.Tensor:  # ddpm / euler_a: one draw per step
            return torch.randn(latents.shape, generator=generator, device=latents.device,
                               dtype=torch.float32)

        with torch.no_grad():
            # ---- inner partial denoise on the CURRENT embedding, guidance 3
            target_seq = encode_spliced(handle, token_ids, slots, emb)
            denoised = diff.diffusion(
                unet, state_n, latents,
                diff.concat_embeddings(pack["uncond_embeds"], target_seq, batch),
                timesteps_to, guidance_scale=inner_guidance_scale,
                noise=noise if generator is not None else None,
            )
            idx = (timesteps_to * num_train_timesteps) // max_denoising_steps
            t = float(state_full.timesteps[idx])
            in_scale = float(state_full.input_scales[idx])

            # ---- 3 reference predictions on fixed embeddings, one call
            ref_preds = unet(denoised.repeat(3, 1, 1, 1) * in_scale, t,
                             pack["ref_embeds"]).float()
            positive, neutral, uncond = ref_preds.chunk(3, dim=0)

        # ---- the target pass: the gradient flows through the UNet and the
        # text encoder into the spliced rows
        ctx = encode_spliced(handle, token_ids, slots, emb).repeat_interleave(batch, dim=0)
        pred = unet(denoised * in_scale, t, ctx)
        loss = esd_loss(pred, positive, uncond, neutral, guidance_scale, erase_sign)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def save_embedding(file: str | os.PathLike, emb: torch.Tensor, name: str = "",
                   save_dtype: torch.dtype = torch.float32,
                   metadata: Optional[dict] = None) -> None:
    """An A1111/webui embedding: `.safetensors` with one `emb_params` tensor
    (n_tokens, hidden) and the metadata `name` (and `metadata`'s entries),
    or `torch.save` of the same dict for any other extension."""
    state = {"emb_params": emb.detach().to("cpu", save_dtype).contiguous()}
    file = os.fspath(file)
    if os.path.splitext(file)[1] == ".safetensors":
        write_safetensors(file, state, {"name": name, **(metadata or {})})
    else:
        torch.save(state, file)


def load_embedding(file: str | os.PathLike) -> torch.Tensor:
    """`save_embedding`'s `emb_params`, on the CPU in its saved dtype."""
    file = os.fspath(file)
    if os.path.splitext(file)[1] == ".safetensors":
        return read_safetensors(file)[0]["emb_params"]
    return torch.load(file, map_location="cpu", weights_only=True)["emb_params"]


def train_textual_inversion(config: RootConfig, prompts: list[PromptSettings],
                            bundle: ModelBundle, handle: TextEncoderHandle,
                            on_step: Optional[Callable] = None) -> dict:
    """The host loop: `trainer.train`'s sampling and save cadence for ONE
    concept (the embedding is the target prompt's own, so exactly one prompt
    entry). Returns {"embedding": fp32 CPU tensor, "slots", "losses",
    "saved": [paths]}. `on_step(i, loss)` is an optional observer hook."""
    if len(prompts) != 1:
        raise ValueError("textual-inversion erasure trains one concept per run; got "
                         f"{len(prompts)} prompt entries")
    if bundle.is_xl:
        raise ValueError("textual inversion targets SD1.x/2.x (see the module docstring)")
    if bundle.encode_fn is None:
        raise ValueError("bundle.encode_fn required")

    settings = prompts[0]
    (pair,) = encode_prompt_pairs(prompts, bundle.encode_fn)
    token_ids, slots, emb0 = init_prompt_embedding(handle, settings.target)
    emb = torch.nn.Parameter(emb0.clone())
    if config.train.checkpoint_unet:
        bundle.unet.checkpoint_unet = True

    lr_at = get_lr_schedule(config.train.lr_scheduler, config.train.lr,
                            config.train.iterations, lr_min=config.train.lr / 100)
    optimizer = get_optimizer(config.train.optimizer, [emb], config.train.lr,
                              config.train.optimizer_args)
    step_fn = make_ti_train_step(bundle, handle, token_ids, slots, optimizer,
                                 config.train.max_denoising_steps)
    refs = build_pack(pair)
    pack = {"uncond_embeds": pair.unconditional, "ref_embeds": refs["ref_embeds"]}

    seed = config.train.seed
    rng = np.random.default_rng(seed)
    generator = torch.Generator(bundle.device)
    generator.manual_seed(seed if seed is not None else int(rng.integers(2**31)))
    save_dtype = parse_precision(config.save.precision)
    save_path = Path(config.save.path)
    save_path.mkdir(parents=True, exist_ok=True)
    metadata = {"config": json.dumps(config.to_dict()), "target": settings.target}

    wandb_run = None
    if config.logging.use_wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=f"LECO_{config.save.name}", config=metadata)
        except ImportError:
            print("wandb not installed; continuing without it")

    losses: list[float] = []
    saved: list[Path] = []
    iterations = config.train.iterations
    per_steps = config.save.per_steps
    height = width = settings.resolution

    def save(p: Path) -> None:
        save_embedding(p, emb, config.save.name, save_dtype, metadata)
        saved.append(p)

    with open(save_path / "metrics.jsonl", "a") as metrics_file:
        for i in range(iterations):
            timesteps_to = int(rng.integers(1, config.train.max_denoising_steps))
            for group in optimizer.param_groups:
                group["lr"] = lr_at(i)
            loss = float(step_fn(emb, pack, pair.guidance_scale, pair.erase_sign,
                                 timesteps_to, height=height, width=width,
                                 generator=generator))
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at iteration {i}")
            losses.append(loss)
            print(f"{i + 1}/{iterations} Loss*1k: {loss * 1000:.4f}")
            record = {"loss": loss, "iteration": i, "lr": lr_at(i),
                      "timesteps_to": timesteps_to}
            metrics_file.write(json.dumps(record) + "\n")
            metrics_file.flush()
            if wandb_run is not None:
                wandb_run.log({"loss": loss, "iteration": i, "lr": lr_at(i)})
            if on_step is not None:
                on_step(i, loss)
            if per_steps > 0 and i % per_steps == 0 and i != 0 and i != iterations - 1:
                save(save_path / f"{config.save.name}_{i}steps_ti.safetensors")
        save(save_path / f"{config.save.name}_ti.safetensors")
    if wandb_run is not None:
        wandb_run.finish()
    return {"embedding": emb.detach().cpu(), "slots": slots, "losses": losses,
            "saved": saved}
