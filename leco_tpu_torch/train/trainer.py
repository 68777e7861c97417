"""The training engine: the ESD train step and the host-side loop.

Counterpart of `leco_tpu/train/trainer.py` (reference train_lora.py:34-321).
One iteration, as in the JAX package:

    fold the LoRA into the base weights once;
    [LoRA folded] t_to UNet forwards @ 2B CFG batch, guidance 3   (no grad)
    [LoRA off   ] 1 UNet forward @ 3B (the three references at guidance 1,
                  where CFG is the conditioned branch alone)       (no grad)
    [LoRA on    ] 1 UNet forward @ B, differentiated
    fp32 ESD loss -> backward -> optimizer step at the schedule's lr

PyTorch runs eagerly, so the step is a plain function and the LoRA weights
and optimizer state live in the model and the torch optimizer. The host loop
draws (pair, timesteps_to, resolution) from the same seeded
`np.random.default_rng` stream in the same order as the JAX package, so the
same config gives the same schedule; latents and the stochastic schedulers'
noise come from one torch generator seeded alongside. Every SD1.x/2.x
option of the JAX trainer runs: the four noise schedulers, the eight
optimizers and five LR schedules, `ema_decay` (an EMA of the LoRA, saved
beside it), `save_state` and `resume` (`train/checkpoint.py`, at the
periodic saves), `checkpoint_unet`, `save.async_write` (periodic saves
copied to the host in the loop and written on a thread; a failed writer
leaves a `_rescue` save and raises) and `logging.use_wandb` (`wandb` is
imported only then; without it the loop says so and trains on).
Refused: `step_chunk > 1` (the JAX package's device-side scan, not
ported). Progress is one printed line per iteration (`Loss*1k`), where the
reference draws a tqdm bar. `LECO_TRAIN_STAGES=1` (the JAX trainer's
knob, read at call time) prints the setup stages, each with the seconds
since train() began.

Data, tensor and spatial parallelism (`leco_tpu_torch.parallel`; the CLIs
build the mesh): a UNet with a parallel context runs each call on this
rank's share and hands back the global output, so the step's latents, the
inner loop and the references are the same global tensors on every rank
(drawn from one shared seed, `parallel.distributed.shared_seed`). The
differentiated target keeps its local share: the ESD loss is taken from
local sums reduced over dp and sp, and the LoRA gradients are summed where
a rank's is a partial (`ParallelContext.reduce_lora_grads`), so a sharded
step computes what the unsharded step computes. Rank 0 alone prints and
writes (saves, `metrics.jsonl`, state snapshots, the wandb run).

SDXL (`ModelBundle.is_xl`, the JAX trainer's): the prompt cache holds
`PromptEmbedsXL`; each pack carries `inner_added`, `ref_added` and
`target_added`, the pooled embeddings in the order of the sequences and the
tiled `time_ids`, which every UNet call of the step receives. A pack is
cached per (pair, height, width), except that a pair with `dynamic_crops`
draws new `time_ids` every iteration from the run's numpy generator.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from leco_tpu_torch.config import RootConfig, parse_precision
from leco_tpu_torch.lora import (
    LoRASpec,
    count_lora_modules,
    folded_lora,
    lora_layers,
    lora_mode,
    lora_parameters,
    save_lora_weights,
)
from leco_tpu_torch.models.unet import UNet2DConditionModel
from leco_tpu_torch.ops import schedulers as sched
from leco_tpu_torch.parallel import distributed
from leco_tpu_torch.prompts import (
    PromptEmbedsCache,
    PromptEmbedsPair,
    PromptSettings,
    esd_loss,
    prompt_encoder,
)
from leco_tpu_torch.train import diffusion as diff
from leco_tpu_torch.train.optim import get_lr_schedule, get_optimizer
from leco_tpu_torch.utils.profiling import RECORDER, clock_ns, span


@dataclasses.dataclass
class ModelBundle:
    """Everything the training loop needs, already on its device."""

    unet: UNet2DConditionModel  # with its LoRA layers added
    scheduler: sched.NoiseScheduler
    spec: LoRASpec
    device: torch.device
    encode_fn: Optional[Callable] = None  # str -> (1, 77, d) tensor [or PromptEmbedsXL]

    @classmethod
    def from_loaded(cls, models, spec: LoRASpec, device) -> "ModelBundle":
        """The bundle of a loader's `LoadedModels`, its prompt encoder the
        CLI's (`prompt_encoder`)."""
        return cls(unet=models.unet, scheduler=models.scheduler, spec=spec,
                   device=torch.device(device), encode_fn=prompt_encoder(models, device))

    @property
    def is_xl(self) -> bool:
        return self.unet.is_xl

    @property
    def lora_params(self) -> dict[str, torch.nn.Parameter]:
        return lora_parameters(self.unet)

    def free_text_encoder(self):
        """The reference deletes the text encoder(s) after caching
        (train_lora.py:134-137, train_lora_xl.py): `encode_fn` holds the
        only references to them (both of SDXL's), so dropping it frees
        them."""
        self.encode_fn = None


def make_train_step(bundle: ModelBundle, optimizer: torch.optim.Optimizer,
                    max_denoising_steps: int, inner_guidance_scale: float = 3.0):
    """-> step(pack, guidance_scale, erase_sign, timesteps_to, *, height,
    width, generator=None, latents=None) -> loss (0-d fp32 tensor on the
    device). `latents` (B, 4, H/8, W/8) replaces the initial latents (the
    draw from `generator` times `init_noise_sigma`); ddpm and euler_a draw
    their per-step noise from `generator` after it.
    The optimizer steps at its `param_groups` lr, which the caller sets."""
    unet = bundle.unet
    scheduler = bundle.scheduler
    state_n = scheduler.set_timesteps(max_denoising_steps)
    state_full = scheduler.set_timesteps(scheduler.num_train_timesteps)
    num_train_timesteps = scheduler.num_train_timesteps

    def step(pack: dict, guidance_scale: float, erase_sign: float,
             timesteps_to: int, *, height: int, width: int,
             generator: Optional[torch.Generator] = None,
             latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("leco.step"):
            batch = pack["target_embeds"].shape[0]
            if latents is None:
                latents = diff.get_initial_latents(
                    generator, state_n, batch, height, width, bundle.device
                )

            def noise(i: int) -> torch.Tensor:  # ddpm / euler_a: one draw per step
                return torch.randn(latents.shape, generator=generator, device=latents.device,
                                   dtype=torch.float32)

            with torch.no_grad():
                # ---- inner partial denoise, LoRA folded, guidance 3
                # (train_lora.py:179-193)
                with folded_lora(unet), span("leco.inner_denoise"):
                    denoised = diff.diffusion(
                        unet, state_n, latents, pack["inner_embeds"], timesteps_to,
                        guidance_scale=inner_guidance_scale,
                        noise=noise if generator is not None else None,
                        added_cond_kwargs=pack.get("inner_added"),
                    )

                # ---- training timestep on the 1000-step schedule
                # (train_lora.py:195-199)
                idx = (timesteps_to * num_train_timesteps) // max_denoising_steps
                t = float(state_full.timesteps[idx])
                in_scale = float(state_full.input_scales[idx])

                # ---- 3 reference predictions, LoRA off, one batched call
                with span("leco.reference_forward"), lora_mode(unet, "off"):
                    ref_preds = unet(denoised.repeat(3, 1, 1, 1) * in_scale, t,
                                     pack["ref_embeds"], pack.get("ref_added")).float()
                positive, neutral, uncond = ref_preds.chunk(3, dim=0)

            # ---- differentiated target prediction, LoRA on (train_lora.py:244-256)
            par = unet.parallel
            # outside leco.optimizer: set_to_none launches nothing, and the
            # gradients stay readable after the step
            optimizer.zero_grad(set_to_none=True)
            if par is None:
                with span("leco.target_forward"):
                    pred = unet(denoised * in_scale, t, pack["target_embeds"],
                                pack.get("target_added"))
                with span("leco.loss"):
                    loss = esd_loss(pred, positive, uncond, neutral, guidance_scale, erase_sign)
                with span("leco.backward"):
                    loss.backward()
            else:  # this rank's share of the prediction, its local sums reduced
                with span("leco.target_forward"):
                    pred, plan = par.call(unet.forward_local, denoised * in_scale, t,
                                          pack["target_embeds"], pack.get("target_added"),
                                          gather=False)
                with span("leco.loss"):
                    loss = par.esd_loss(pred, positive, uncond, neutral, guidance_scale,
                                        erase_sign, plan)
                with span("leco.backward"):
                    loss.backward()
                    par.reduce_lora_grads(lora_layers(unet), plan)
            with span("leco.optimizer"):
                optimizer.step()
            return loss.detach()

    return step


def build_pack(pair: PromptEmbedsPair, is_xl: bool = False, height: int = 0,
               width: int = 0, rng: Optional[np.random.Generator] = None) -> dict:
    """The per-iteration embedding batches for one prompt pair: inner
    [uncond]*b + [target]*b, references [positive]*b + [neutral]*b +
    [uncond]*b, target [target]*b. SDXL (cache values PromptEmbedsXL) adds
    `inner_added`, `ref_added` and `target_added`: the pooled embeddings in
    the same order and `get_add_time_ids(height, width)` tiled, drawn from
    `rng` under the pair's `dynamic_crops` (JAX trainer.py:337-389)."""
    b = pair.batch_size

    def seq(e):
        return e.text_embeds if is_xl else e

    target, positive, uncond, neutral = (pair.target, pair.positive, pair.unconditional,
                                         pair.neutral)
    pack = {
        "inner_embeds": diff.concat_embeddings(seq(uncond), seq(target), b),
        "ref_embeds": torch.cat(
            [
                seq(positive).repeat_interleave(b, dim=0),
                seq(neutral).repeat_interleave(b, dim=0),
                seq(uncond).repeat_interleave(b, dim=0),
            ],
            dim=0,
        ),
        "target_embeds": seq(target).repeat_interleave(b, dim=0),
    }
    if is_xl:
        time_ids = torch.from_numpy(diff.get_add_time_ids(
            height, width, dynamic_crops=pair.dynamic_crops, rng=rng)).to(
                target.pooled_embeds.device)

        def added(embeds: list, n: int) -> dict:
            pooled = torch.cat([e.pooled_embeds.repeat_interleave(b, dim=0) for e in embeds])
            return {"text_embeds": pooled, "time_ids": time_ids.repeat(n * b, 1)}

        pack["inner_added"] = added([uncond, target], 2)
        pack["ref_added"] = added([positive, neutral, uncond], 3)
        pack["target_added"] = added([target], 1)
    return pack


def encode_prompt_pairs(prompts: list[PromptSettings],
                        encode_fn: Callable) -> list[PromptEmbedsPair]:
    """Encode each unique prompt once (train_lora.py:106-132)."""
    cache = PromptEmbedsCache()
    pairs = []
    for settings in prompts:
        for prompt in (settings.target, settings.positive, settings.neutral,
                       settings.unconditional):
            if cache[prompt] is None:
                cache[prompt] = encode_fn(prompt)
        pairs.append(
            PromptEmbedsPair(
                cache[settings.target],
                cache[settings.positive],
                cache[settings.unconditional],
                cache[settings.neutral],
                settings,
            )
        )
    return pairs




def _refuse_unported(config: RootConfig) -> None:
    if config.train.step_chunk > 1:
        raise NotImplementedError("not ported: train.step_chunk > 1")


def run_generators(seed: Optional[int], device) -> tuple[np.random.Generator, torch.Generator]:
    """The run's host stream (pair, timesteps_to, resolution draws) and its
    latent generator, from `seed` shared by every rank (`shared_seed`: with
    seed None rank 0's draw), so that every rank draws the same schedule
    and latents."""
    seed = distributed.shared_seed(seed, device)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device)
    generator.manual_seed(seed if seed is not None else int(rng.integers(2**31)))
    return rng, generator


def _copy_tree(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def train(config: RootConfig, prompts: list[PromptSettings], bundle: ModelBundle,
          on_step: Optional[Callable] = None) -> dict:
    """The training loop (reference train(), train_lora.py:34-321).

    Returns {"lora": {name: CPU tensor}, "losses": [...], "saved": [paths],
    "ema": {name: CPU tensor} or None}. `on_step(i, loss)` is an optional
    observer hook. Under torch.distributed every rank runs it; rank 0 alone
    prints and writes, and its "saved" lists the files (the others' is
    empty)."""
    _refuse_unported(config)
    main = distributed.rank() == 0

    def print(*args, **kw):  # noqa: A001 - rank 0 speaks for the run
        if main:
            builtins.print(*args, **kw)

    # LECO_TRAIN_STAGES=1: timestamped setup stages, in the JAX trainer's
    # format and at its eight points (the time to the first loss, stage by
    # stage); with the recorder on, each is a point span on its clock
    t_start = clock_ns()
    show_stages = os.environ.get("LECO_TRAIN_STAGES") == "1"

    def stage(msg: str) -> None:
        if RECORDER.on:
            with span(f"leco.stage: {msg}"):
                pass
        if show_stages:
            seconds = (clock_ns() - t_start) / 1e9
            print(f"[train +{seconds:7.1f}s] {msg}", flush=True)

    metadata = {
        "prompts": ",".join(json.dumps(p.to_dict()) for p in prompts),
        "config": json.dumps(config.to_dict()),
    }
    save_path = Path(config.save.path)
    if config.logging.verbose:
        print(metadata)
    wandb_run = None
    if config.logging.use_wandb and main:
        try:
            import wandb

            wandb_run = wandb.init(project=f"LECO_{config.save.name}", config=metadata)
        except ImportError:
            print("wandb not installed; continuing without it")
    save_dtype = parse_precision(config.save.precision)

    rng, generator = run_generators(config.train.seed, bundle.device)

    # ---- prompt encoding, once (train_lora.py:106-137)
    if bundle.encode_fn is None:
        raise ValueError("bundle.encode_fn required")
    stage("setup: begin prompt encoding")
    pairs = encode_prompt_pairs(prompts, bundle.encode_fn)
    bundle.free_text_encoder()
    stage("setup: prompts encoded")

    lora = bundle.lora_params
    print(f"create LoRA for U-Net: {count_lora_modules(lora)} modules.")
    for settings in prompts:
        print(settings)
    if config.train.checkpoint_unet:
        bundle.unet.checkpoint_unet = True

    # ---- optimizer (train_lora.py:80-95); the lr of iteration j is set
    # before its step, where optax evaluates the schedule
    lr_at = get_lr_schedule(config.train.lr_scheduler, config.train.lr,
                            config.train.iterations, lr_min=config.train.lr / 100)
    stage("setup: lr schedule built (a host function, evaluated each iteration)")
    optimizer = get_optimizer(config.train.optimizer, list(lora.values()),
                              config.train.lr, config.train.optimizer_args)
    stage("setup: optimizer built (its state is made at the first step)")

    # ---- optional EMA of the LoRA weights, started at the weights
    ema_decay = float(config.train.ema_decay)
    ema = None
    if ema_decay != 0.0:
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"train.ema_decay must be in (0, 1), got {ema_decay}")
        ema = _copy_tree(lora)

    # ---- optional full-state resume from the newest snapshot
    state_dir = save_path / "state"
    start_iteration = 0
    if config.train.resume:
        from leco_tpu_torch.train import checkpoint as ckpt

        # rank 0 alone writes snapshots, so it alone reads one: every rank
        # resumes from its state, whether or not the ranks share save.path
        restored = distributed.from_rank0(ckpt.restore_train_state(state_dir) if main else None)
        if restored is not None:
            restored = ckpt.to_device(restored, bundle.device)
            if set(restored["lora"]) != set(lora):
                raise ValueError(f"{state_dir}: the snapshot's LoRA tensors are not this "
                                 "model's")
            with torch.no_grad():
                for k, p in lora.items():
                    p.copy_(restored["lora"][k])
            optimizer.load_state_dict(restored["optimizer"])
            start_iteration = restored["iteration"] + 1
            generator.set_state(restored["generator"])
            rng = restored["rng"]
            if ema is not None:
                # a snapshot from before EMA was on restarts it from the weights
                ema = _copy_tree(restored.get("ema", restored["lora"]))
            print(f"resumed from {state_dir} at iteration {start_iteration}")

    step_fn = make_train_step(bundle, optimizer, config.train.max_denoising_steps)
    stage("setup: step_fn built (eager: nothing to trace)")

    losses: list[float] = []
    saved: list[Path] = []
    if main:
        save_path.mkdir(parents=True, exist_ok=True)
    pack_cache: dict = {}
    # losses stay on the device until `logging.interval` of them are
    # pending, then come to the host in one transfer (the host syncs with
    # the device once per interval, not once per iteration)
    pending: list = []
    save_threads: list[threading.Thread] = []
    save_errors: list[Exception] = []

    def submit_save(p: Path, tree: dict) -> None:
        """Write `tree` to `p` now, or under `save.async_write` copy it to
        host tensors here and write it on a thread. Only rank 0 writes."""
        if not main:
            return
        saved.append(p)
        if not config.save.async_write:
            save_lora_weights(p, tree, bundle.spec, save_dtype, metadata)
            return
        snapped = {k: v.detach().to("cpu", save_dtype, copy=True) for k, v in tree.items()}

        def write() -> None:
            try:
                save_lora_weights(p, snapped, bundle.spec, save_dtype, metadata)
            except Exception as e:  # raised in the loop's thread, at the final join
                save_errors.append(e)

        thread = threading.Thread(target=write, name=f"leco-save-{p.name}")
        thread.start()
        save_threads.append(thread)

    with (open(save_path / "metrics.jsonl", "a") if main
          else contextlib.nullcontext()) as metrics_file:

        def drain() -> None:
            if not pending:
                return
            values = torch.stack([loss for _, loss in pending]).cpu().tolist()
            if not losses:
                stage("loop: first losses fetched (device pipeline live)")
            for (meta, _), loss_val in zip(pending, values):
                j, j_tsto, j_h, j_w = meta
                if not np.isfinite(loss_val):
                    # stop before a save can overwrite good weights
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at iteration {j}; aborting "
                        "(last good LoRA weights are in the previous periodic save)"
                    )
                losses.append(loss_val)
                print(f"{j + 1}/{config.train.iterations} Loss*1k: {loss_val * 1000:.4f}")
                record = {"loss": loss_val, "iteration": j, "lr": lr_at(j),
                          "timesteps_to": j_tsto, "resolution": [j_h, j_w]}
                if main:
                    metrics_file.write(json.dumps(record) + "\n")
                    metrics_file.flush()
                if wandb_run is not None:
                    wandb_run.log({"loss": loss_val, "iteration": j, "lr": lr_at(j)})
                if on_step is not None:
                    on_step(j, loss_val)
            pending.clear()

        iterations = config.train.iterations
        per_steps = config.save.per_steps
        stage("loop: entering (next: the first step, run eagerly)")
        for i in range(start_iteration, iterations):
            # a failed background writer stops the run at once; the
            # in-memory weights are rescued below
            if save_errors:
                break
            # sampling order of train_lora.py:141-176
            pair = pairs[int(rng.integers(0, len(pairs)))]
            timesteps_to = int(rng.integers(1, config.train.max_denoising_steps))
            height, width = pair.resolution, pair.resolution
            if pair.dynamic_resolution:
                height, width = diff.get_random_resolution_in_bucket(
                    rng, pair.resolution
                )
            if config.logging.verbose:
                print("guidance_scale:", pair.guidance_scale)
                print("resolution:", pair.resolution)
                print("dynamic_resolution:", pair.dynamic_resolution)
                if pair.dynamic_resolution:
                    print("bucketed resolution:", (height, width))
                print("batch_size:", pair.batch_size)
            # SDXL's dynamic_crops re-rolls time_ids every iteration (JAX
            # trainer.py:803-815); every other pack is cached
            if bundle.is_xl and pair.dynamic_crops:
                pack = build_pack(pair, True, height, width, rng=rng)
            else:
                key = (id(pair), height, width)
                pack = pack_cache.get(key)
                if pack is None:
                    pack = pack_cache[key] = build_pack(pair, bundle.is_xl, height, width)

            for group in optimizer.param_groups:
                group["lr"] = lr_at(i)
            loss = step_fn(pack, pair.guidance_scale, pair.erase_sign,
                           timesteps_to, height=height, width=width,
                           generator=generator)
            if i == start_iteration:
                stage("loop: first step returned (kernels queued)")
            if ema is not None:
                ema_values = list(ema.values())
                torch._foreach_mul_(ema_values, ema_decay)
                torch._foreach_add_(ema_values, torch._foreach_mul(
                    [lora[k].detach() for k in ema], 1.0 - ema_decay))
            pending.append(((i, timesteps_to, height, width), loss))
            if len(pending) >= max(1, config.logging.interval):
                drain()

            # periodic save (train_lora.py:292-302); per_steps <= 0 means
            # "final save only"
            if (per_steps > 0 and i % per_steps == 0 and i != 0
                    and i != iterations - 1):
                drain()
                print("Saving...")
                submit_save(save_path / f"{config.save.name}_{i}steps.safetensors", lora)
                if ema is not None:
                    submit_save(save_path / f"{config.save.name}_{i}steps_ema.safetensors",
                                ema)
                if config.train.save_state and main:
                    from leco_tpu_torch.train import checkpoint as ckpt

                    ckpt.save_train_state(
                        state_dir, lora=lora, optimizer=optimizer.state_dict(), iteration=i,
                        generator_state=generator.get_state(), rng=rng, ema=ema)

        drain()
        # every periodic writer lands (or its failure surfaces) before the
        # final save
        for thread in save_threads:
            thread.join()
        if save_errors:
            # keep the in-memory weights under a name of their own, never
            # over a `_last` that may be good, then raise the writer's error
            rescue = save_path / f"{config.save.name}_rescue.safetensors"
            try:
                save_lora_weights(rescue, lora, bundle.spec, save_dtype, metadata)
                saved.append(rescue)
                print(f"background save failed; weights rescued to {rescue}")
            except Exception as rescue_err:
                print(f"background save failed AND rescue save failed: {rescue_err}")
            raise save_errors[0]
        print("Saving...")
        for p, tree in ((f"{config.save.name}_last.safetensors", lora),
                        (f"{config.save.name}_last_ema.safetensors", ema)):
            if tree is not None and main:
                save_lora_weights(save_path / p, tree, bundle.spec, save_dtype, metadata)
                saved.append(save_path / p)
    if wandb_run is not None:
        wandb_run.finish()
    print("Done.")
    return {
        "lora": {k: v.detach().cpu() for k, v in lora.items()},
        "losses": losses,
        "saved": saved,
        "ema": None if ema is None else {k: v.cpu() for k, v in ema.items()},
    }
