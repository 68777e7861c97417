"""The reference's LoRA erase train step, followed step by step.

One step at `t_to`, as the published recipe (the ESD objective) defines it:

    the LoRA folded into the weights: t_to DDIM steps (eta 0) from the
      initial latents, each a CFG prediction at guidance 3 of the
      [unconditional, target] batch at 2B;
    the LoRA off: the noise predictions of [positive, neutral,
      unconditional] at 3B on the denoised latents, at the training
      timestep of the 1000-step schedule (index t_to * 1000 // 50);
    the LoRA on: the target's prediction at B, differentiated;
    loss = mean((target - (neutral - sign * g * (positive - unconditional)))^2)
    in float32, then AdamW (decoupled weight decay) on the LoRA tree.

Every UNet call runs in blocks of at most `chunk` samples, so that the
float32 reference fits beside nothing else on the card; the target's
backward accumulates its gradients block by block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import precision
from .unet import UNet

BETA_START, BETA_END, TRAIN_STEPS = 0.00085, 0.012, 1000


@dataclasses.dataclass
class Recipe:
    batch: int
    max_denoising_steps: int
    inner_guidance_scale: float
    guidance_scale: float
    erase_sign: float
    lr: float
    betas: tuple
    eps: float
    weight_decay: float


@dataclasses.dataclass
class Followed:
    """What the reference (or a side put in the program's place) did."""

    losses: list  # each step's loss, floats
    first_grad: dict  # {leaf: the first step's gradient}
    grad_norms: list  # each step's {leaf: gradient norm}
    params: dict  # {leaf: the LoRA after the last step}
    state: dict | None = None  # AdamW's after the last step: {"step", "moments"}


def ddim_tables(steps: int) -> dict:
    """The "leading" DDIM schedule of `steps` steps over the scaled-linear
    betas: timesteps and the four square roots, float32 as a step uses
    them."""
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, TRAIN_STEPS, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    ratio = TRAIN_STEPS // steps
    ts = (np.arange(steps) * ratio)[::-1]
    prev = ts - ratio
    a_t = acp[ts]
    a_prev = np.where(prev >= 0, acp[np.clip(prev, 0, TRAIN_STEPS - 1)], 1.0)
    f32 = np.float32
    return {"t": ts.astype(f32), "sa": np.sqrt(a_t).astype(f32),
            "s1ma": np.sqrt(1 - a_t).astype(f32), "sap": np.sqrt(a_prev).astype(f32),
            "s1map": np.sqrt(1 - a_prev).astype(f32)}


def training_timestep(t_to: int, steps: int) -> float:
    """The timestep of the 1000-step schedule at index t_to * 1000 // steps."""
    idx = t_to * TRAIN_STEPS // steps
    return float(TRAIN_STEPS - 1 - idx)


def _batch(feed: dict, keys: list, b: int):
    """(text, added) of the prompts `keys`, each repeated b times."""
    text = torch.cat([feed["text"][k].float().expand(b, -1, -1) for k in keys])
    if feed.get("pooled") is None:
        return text, None
    pooled = torch.cat([feed["pooled"][k].float().expand(b, -1) for k in keys])
    time_ids = feed["time_ids"].float().expand(len(keys) * b, -1)
    return text, {"text_embeds": pooled, "time_ids": time_ids}


def _call(unet: UNet, x, t, text, added, chunk: int) -> torch.Tensor:
    outs = []
    for s in range(0, x.shape[0], chunk):
        a = None if added is None else {k: v[s:s + chunk] for k, v in added.items()}
        outs.append(unet(x[s:s + chunk], t, text[s:s + chunk], a))
    return torch.cat(outs)


def follow(unet: UNet, tree: dict, feed: dict, recipe: Recipe, latents: list, t_tos: list,
           chunk: int, rounding: str = "fp32", state: dict | None = None) -> Followed:
    """Run the steps at `t_tos` from `latents` (one (B, 4, h, w) tensor a
    step) on `unet` and its LoRA tree `tree`, in the operand `rounding`
    ("fp32", or the control's "fp8"). AdamW starts from `state` ({"step":
    steps taken, "moments": {leaf: (exp_avg, exp_avg_sq)}}), or fresh."""
    b = recipe.batch
    run = unet.run
    run.round_operand = precision.ROUNDINGS[rounding]
    sched = ddim_tables(recipe.max_denoising_steps)
    inner_text, inner_added = _batch(feed, ["unconditional", "target"], b)
    ref_text, ref_added = _batch(feed, ["positive", "neutral", "unconditional"], b)
    tgt_text, tgt_added = _batch(feed, ["target"], b)
    if state is None:
        state = {"step": 0, "moments": {k: (torch.zeros_like(p), torch.zeros_like(p))
                                        for k, p in tree.items()}}
    moments = {k: (m.float().clone(), v.float().clone())
               for k, (m, v) in state["moments"].items()}
    b1, b2 = recipe.betas
    losses, grad_norms, first_grad = [], [], None
    for step, (lat, t_to) in enumerate(zip(latents, t_tos), start=state["step"] + 1):
        with torch.no_grad():
            run.mode = "folded"
            x = lat.float()
            for i in range(t_to):
                eps = _call(unet, torch.cat([x, x]), float(sched["t"][i]), inner_text,
                            inner_added, chunk)
                uncond, cond = eps.chunk(2)
                eps = uncond + recipe.inner_guidance_scale * (cond - uncond)
                x0 = (x - float(sched["s1ma"][i]) * eps) / float(sched["sa"][i])
                x = float(sched["sap"][i]) * x0 + float(sched["s1map"][i]) * eps
            t = training_timestep(t_to, recipe.max_denoising_steps)
            run.mode = "off"
            positive, neutral, uncond = _call(unet, x.repeat(3, 1, 1, 1), t, ref_text,
                                              ref_added, chunk).chunk(3)
            goal = neutral - recipe.erase_sign * recipe.guidance_scale * (positive - uncond)
        run.mode = "on"
        for p in tree.values():
            p.grad = None
        total = 0.0
        for s in range(0, b, chunk):
            added = None if tgt_added is None else {k: v[s:s + chunk]
                                                    for k, v in tgt_added.items()}
            pred = unet(x[s:s + chunk], t, tgt_text[s:s + chunk], added)
            part = ((pred - goal[s:s + chunk]) ** 2).sum() / goal.numel()
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads = {k: p.grad.detach().clone() for k, p in tree.items()}
        grad_norms.append({k: float(g.norm()) for k, g in grads.items()})
        if first_grad is None:
            first_grad = grads
        with torch.no_grad():
            for k, p in tree.items():
                m, v = moments[k]
                g = grads[k]
                p.mul_(1 - recipe.lr * recipe.weight_decay)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** step) ** 0.5).add_(recipe.eps)
                p.addcdiv_(m, denom, value=-recipe.lr / (1 - b1 ** step))
    run.round_operand = precision.fp32
    run.mode = "on"
    return Followed(losses, first_grad, grad_norms,
                    {k: p.detach().clone() for k, p in tree.items()},
                    {"step": state["step"] + len(t_tos), "moments": moments})
