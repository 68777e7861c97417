"""The LoRA erase training runner: the window drives the train step of
`leco_tpu_torch.train.trainer.make_train_step` as `trainer.train` does at
`logging.interval` 1 (each iteration's loss fetched before the next is
enqueued), over antithetic `timesteps_to` pairs.

Set-up (counted in `setup_s`): the program's UNet built on the meta device
and given the weights drawn on the card from the seed, its LoRA (the drawn
factors), the AdamW of `train.optim.get_optimizer`, the step, the embedding
pack of `trainer.build_pack`, and ceil(`checked_steps` / 2) pairs of
iterations through the window's own call and feed (the first loads or
builds the kernels' library and warms every shape of the cell). Its first
`checked_steps` iterations are the ones the reference follows from the
seed: their losses, the first gradient as AdamW holds it after one step,
and the LoRA after them.

The window runs whole pairs until `--seconds` have passed and ends at the
last pair's loss fetch; `peak_mem_gib` is its peak, reset at its start.
Then one further pair runs through the same call and is checked too: the
LoRA and AdamW's state are copied before it, and the reference follows it
from that copy, so that a step which changes once the set-up is over is
held to the reference as well. With `--trace 1` one more pair is then
profiled (`tracing.py`). Then the program is freed, the weights are drawn
again, and the float32 reference (TF32 off) follows the checked steps from
the same weights, LoRA, embeddings, latents and timesteps. The recipe's
numbers (guidance, AdamW's betas, eps and weight decay) come to the
reference from the traffic file, never from the program.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time

import torch

import draws
import flops
import roofline
import tracing
from compare import judge, readings
from reference import train as ref_train
from reference import unet as ref_unet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ERASE_SIGN = {"erase": 1.0, "enhance": -1.0}


def program_unet_config(unet: dict):
    """The program's UNetConfig of a diffusers `unet/config.json` dict."""
    from leco_tpu_torch.models.unet import UNetConfig

    s = ref_unet.UNetSizes.from_config(unet)
    return UNetConfig(
        in_channels=s.in_channels, out_channels=s.out_channels,
        down_block_types=s.down_block_types, up_block_types=s.up_block_types,
        block_out_channels=s.block_out_channels, layers_per_block=s.layers_per_block,
        transformer_layers_per_block=s.transformer_layers_per_block,
        cross_attention_dim=s.cross_attention_dim, attention_head_dim=s.attention_head_dim,
        use_linear_projection=s.use_linear_projection,
        upcast_attention=bool(unet.get("upcast_attention", False)),
        addition_embed_type=s.addition_embed_type,
        addition_time_embed_dim=s.addition_time_embed_dim,
        projection_class_embeddings_input_dim=s.projection_class_embeddings_input_dim,
        norm_num_groups=s.norm_num_groups,
    )


@dataclasses.dataclass
class Inputs:
    """What a run draws from its seed, handed to both sides."""

    sizes: ref_unet.UNetSizes
    shapes: dict  # base weight name -> shape
    lora_init: dict  # LoRA leaf -> initial value
    embeds: dict
    pairs: draws.TimestepPairs
    latents: draws.Latents


def draw_inputs(cell, device) -> Inputs:
    tr = cell.traffic
    sizes = ref_unet.UNetSizes.from_config(cell.config["unet"])
    res = tr["resolution"]
    shapes, lora_shapes = ref_unet.shapes(sizes, tr["network"]["rank"])
    return Inputs(
        sizes=sizes,
        shapes=shapes,
        lora_init=draws.lora_init(lora_shapes, cell.seed, device),
        embeds=draws.embeddings(cell.seed, device, sizes.cross_attention_dim,
                                flops.TEXT_TOKENS,
                                sizes.pooled_dim if sizes.addition_embed_type else None),
        pairs=draws.TimestepPairs(cell.seed, tr["t_to"]["low"], tr["t_to"]["high"]),
        latents=draws.Latents(cell.seed, device, (tr["batch_size"], 4, res // 8, res // 8)),
    )


def weights(cell, inputs: Inputs, device) -> dict:
    return draws.unet_weights(inputs.shapes, cell.seed, device,
                              DTYPES[cell.traffic["precision"]])


def build_program(cell, device, inputs: Inputs):
    """The program's bundle, optimizer, step, LoRA tree and embedding pack
    (`trainer.build_pack`), on the drawn weights and LoRA."""
    from leco_tpu_torch.lora import LoRASpec, apply_lora_spec, lora_parameters
    from leco_tpu_torch.models.unet import UNet2DConditionModel
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.ops.schedulers import NoiseScheduler
    from leco_tpu_torch.prompts import PromptEmbedsPair, PromptEmbedsXL, PromptSettings
    from leco_tpu_torch.train.optim import get_optimizer
    from leco_tpu_torch.train.trainer import ModelBundle, build_pack, make_train_step

    tr = cell.traffic
    with torch.device("meta"):
        unet = UNet2DConditionModel(program_unet_config(cell.config["unet"]),
                                    dtype=DTYPES[tr["precision"]],
                                    attn_backend=default_backend(device))
    drawn = weights(cell, inputs, device)
    differ = set(unet.state_dict()) ^ set(drawn)
    if differ:
        raise KeyError(f"the drawn weights and the program's UNet differ in "
                       f"{sorted(differ)[:5]}")
    for name, value in drawn.items():
        module_name, leaf = name.rsplit(".", 1)
        setattr(unet.get_submodule(module_name), leaf,
                torch.nn.Parameter(value, requires_grad=False))
    del drawn
    net = tr["network"]
    spec = LoRASpec(rank=net["rank"], alpha=net["alpha"], network_type=net["type"],
                    train_method=net["training_method"])
    apply_lora_spec(unet, spec, torch.Generator(device))
    params = lora_parameters(unet)
    if set(params) != set(inputs.lora_init):
        raise KeyError("the program's LoRA layers are not the reference's")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(inputs.lora_init[k])
    bundle = ModelBundle(unet=unet, spec=spec, device=torch.device(device),
                         scheduler=NoiseScheduler(tr["scheduler"],
                                                  cell.config["prediction_type"]))
    optimizer = get_optimizer(tr["optimizer"]["name"], list(params.values()),
                              tr["optimizer"]["lr"])
    step = make_train_step(bundle, optimizer, tr["max_denoising_steps"],
                           tr["inner_guidance_scale"])

    res = tr["resolution"]
    settings = PromptSettings.from_dict({
        "target": "target", "positive": "positive", "neutral": "neutral",
        "unconditional": "unconditional", "action": tr["action"],
        "guidance_scale": tr["guidance_scale"], "resolution": res,
        "batch_size": tr["batch_size"]})
    text, pooled = inputs.embeds["text"], inputs.embeds["pooled"]

    def prompt(k):
        return text[k] if pooled is None else PromptEmbedsXL(text[k], pooled[k])

    pair = PromptEmbedsPair(prompt("target"), prompt("positive"), prompt("unconditional"),
                            prompt("neutral"), settings)
    pack = build_pack(pair, pooled is not None, res, res)
    return bundle, optimizer, step, params, (pack, pair.guidance_scale, pair.erase_sign)


def recipe(cell) -> ref_train.Recipe:
    tr = cell.traffic
    opt = tr["optimizer"]
    return ref_train.Recipe(
        batch=tr["batch_size"], max_denoising_steps=tr["max_denoising_steps"],
        inner_guidance_scale=tr["inner_guidance_scale"], guidance_scale=tr["guidance_scale"],
        erase_sign=ERASE_SIGN[tr["action"]], lr=opt["lr"], betas=tuple(opt["betas"]),
        eps=opt["eps"], weight_decay=opt["weight_decay"])


def reference_feed(embeds: dict, res: int) -> dict:
    feed = {"text": embeds["text"], "pooled": embeds["pooled"], "time_ids": None}
    if embeds["pooled"] is not None:  # SDXL: (orig h, orig w, crop top, left, h, w)
        feed["time_ids"] = torch.tensor([[res, res, 0, 0, res, res]], dtype=torch.float32,
                                        device=embeds["pooled"]["target"].device)
    return feed


def reference_chunk(res: int) -> int:
    """Samples a reference UNet call takes at once: 4 at 512 px, 1 at 1024."""
    return max(1, 4 * 512 * 512 // (res * res))


def reference_model(cell, device, inputs: Inputs):
    """The float32 reference (TF32 off) on the weights drawn again ->
    (model, its LoRA tree)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = cell.traffic["network"]
    return ref_unet.build(inputs.sizes, weights(cell, inputs, device), net["rank"],
                          net["alpha"], inputs.lora_init)


def follow(cell, model, inputs: Inputs, lora: dict, lat: list, t_tos: list,
           rounding: str = "fp32", state: dict | None = None):
    """The reference `model`, in `rounding`, over the steps at `t_tos` from
    `lat`, its LoRA set to `lora` and AdamW started from `state` (or fresh)."""
    unet, tree = model
    with torch.no_grad():
        for k, p in tree.items():
            p.copy_(lora[k])
    return ref_train.follow(unet, tree, reference_feed(inputs.embeds,
                                                       cell.traffic["resolution"]),
                            recipe(cell), lat, t_tos,
                            reference_chunk(cell.traffic["resolution"]), rounding, state)


def adam_state(optimizer, params: dict) -> dict:
    """A copy of AdamW's state of the LoRA tree: {"step", "moments"}; a
    state that never stepped holds zero moments (no gradient got through)."""
    steps, moments = set(), {}
    for k, p in params.items():
        st = optimizer.state.get(p, {})
        steps.add(int(st["step"]) if "step" in st else 0)
        moments[k] = tuple(st[m].detach().float().clone() if m in st else torch.zeros_like(p)
                           for m in ("exp_avg", "exp_avg_sq"))
    if len(steps) != 1:
        raise ValueError(f"the LoRA's leaves took different numbers of steps: {sorted(steps)}")
    return {"step": steps.pop(), "moments": moments}


def checked_steps(iterate, optimizer, params: dict, steps: list):
    """Run `steps` ([(t_to, latents)]) through the program, recording what
    the reference is held to -> (the side's record, its LoRA and AdamW's
    state before the steps). The first gradient is worked out from AdamW's
    first moment before and after the first step."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    start = adam_state(optimizer, params)
    start_lora = {k: p.detach().clone() for k, p in params.items()}
    side = ref_train.Followed(losses=[], first_grad={}, grad_norms=[], params={})
    for i, (t_to, lat) in enumerate(steps):
        side.losses.append(iterate(t_to, lat))
        if i == 0:
            after = adam_state(optimizer, params)["moments"]
            side.first_grad = {k: (after[k][0] - beta1 * start["moments"][k][0]) / (1 - beta1)
                               for k in params}
    side.params = {k: p.detach().clone() for k, p in params.items()}
    return side, start_lora, start


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run(cell) -> dict:
    return run_on(cell, "cuda")


def stage(cell, what: str) -> None:
    """A line on standard error: seconds since the process started."""
    print(f"[{time.time() - cell.process_start:8.2f}s] {what}", file=sys.stderr, flush=True)


def run_on(cell, device: str, fault=None, late_witness: str | None = None) -> dict:
    """The whole run on `device`. `fault(bundle, optimizer, step) -> step`
    plants a fault in the timed path (the fault tests). `late_witness`, a
    rounding of the reference, follows the pair after the window in it too,
    from the same copy of the program's state, and reads it against the
    float32 reference (`reference["late_witness"]`; `readings.py`)."""
    tr = cell.traffic
    res, batch = tr["resolution"], tr["batch_size"]
    on_card = torch.device(device).type == "cuda"
    stage(cell, "set-up: begin")
    inputs = draw_inputs(cell, device)
    bundle, optimizer, step, params, (pack, gs, sign) = build_program(cell, device, inputs)
    stage(cell, "set-up: program built on the drawn weights")
    if fault is not None:
        step = fault(bundle, optimizer, step)

    def iterate(t_to: int, lat: torch.Tensor) -> float:
        return step(pack, gs, sign, t_to, height=res, width=res, latents=lat).item()

    # ---- set-up pairs; the first `checked_steps` are the ones compared
    checked = tr["checked_steps"]
    setup = [(t_to, inputs.latents.next()) for _ in range(max(1, math.ceil(checked / 2)))
             for t_to in inputs.pairs.next_pair()]
    side, _, _ = checked_steps(iterate, optimizer, params, setup[:checked])
    for t_to, lat in setup[checked:]:
        iterate(t_to, lat)
    stage(cell, f"set-up: iterations at t_to {[t for t, _ in setup]}, checked losses "
                f"{side.losses}")
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - cell.process_start

    # ---- the window: whole pairs until `seconds` have passed
    t0 = time.perf_counter()
    window_t, losses, pair_ends = [], [], []
    while True:
        for t_to in inputs.pairs.next_pair():
            window_t.append(t_to)
            losses.append(iterate(t_to, inputs.latents.next()))
        pair_ends.append(time.perf_counter() - t0)
        if pair_ends[-1] >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    pair_s = [round(b - a, 3) for a, b in zip([0.0] + pair_ends, pair_ends)]
    stage(cell, f"window: {len(losses)} iterations in {window_s:.3f}s; seconds a pair "
                f"{pair_s}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # ---- one more pair, checked from a copy of the state the window left
    late = [(t_to, inputs.latents.next()) for t_to in inputs.pairs.next_pair()]
    late_side, late_lora, late_state = checked_steps(iterate, optimizer, params, late)
    stage(cell, f"checked pair after the window at t_to {[t for t, _ in late]}, "
                f"AdamW step {late_state['step']}: losses {late_side.losses}")
    record = {
        "attempted": len(losses),
        "failed": sum(1 for x in losses if not math.isfinite(x)),
        "window_s": window_s, "window_t_to": window_t, "setup_s": setup_s, "pair_s": pair_s,
        "peak_bytes": peak,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": max(peak, setup_peak),
                   "power_limit": power_limit() if on_card else None},
    }

    if cell.trace and on_card:
        pair = inputs.pairs.next_pair()

        def run_pair():
            for t_to in pair:
                iterate(t_to, inputs.latents.next())

        session = tracing.profile_pair(run_pair, bundle.unet)
        stage(cell, f"traced pair {pair}: {session['wall_s']:.3f}s wall")
        traced = tracing.analyze(session, len(pair))
        per_it = {k: round(v / len(pair), 3) for k, v in traced["by_category_ms"].items()}
        stage(cell, f"traced pair read; device ms an iteration by category {per_it}")
        per_it = {k: round(v / len(pair), 3) for k, v in traced["by_component_ms"].items()}
        stage(cell, f"device ms an iteration by UNet component {per_it}")
        calls = flops.attention_calls(inputs.sizes, res, batch)
        fwd_bound = sum(roofline.bound_ms(*roofline.attention_core_work(*c)) for c in calls)
        traced["core_bound_ms"] = fwd_bound * sum(2 * t + 3 + 1 for t in pair)
        traced["pair_t_to"] = list(pair)
        record["trace"] = traced
        net = tr["network"]
        record["window_flops"] = sum(
            flops.step_flops(inputs.sizes, res, batch, net["rank"], net["alpha"], t)
            for t in window_t)
        record["peak_flops"] = roofline.BF16_TENSOR_FLOPS
        record["device"]["busy_s"] = traced["busy_s"]
        record["device"]["window_s"] = traced["wall_s"]
        record["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}

    # ---- the reference, once the program is freed
    del bundle, optimizer, step, params, pack
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = reference_model(cell, device, inputs)
    ref = follow(cell, model, inputs, inputs.lora_init, [lat for _, lat in setup[:checked]],
                 [t for t, _ in setup[:checked]])
    values, where = readings(side, ref, inputs.lora_init)
    late_ref = follow(cell, model, inputs, late_lora, [lat for _, lat in late],
                      [t for t, _ in late], state=late_state)
    late_values, late_where = readings(late_side, late_ref, late_lora)
    values.update({f"late.{k}": v for k, v in late_values.items()})
    where.update({f"late.{k}": v for k, v in late_where.items()})
    witness = None
    if late_witness is not None:
        low = follow(cell, model, inputs, late_lora, [lat for _, lat in late],
                     [t for t, _ in late], rounding=late_witness, state=late_state)
        witness = dict(zip(("readings", "where"), readings(low, late_ref, late_lora)))
    del model
    seconds = time.perf_counter() - t0
    stage(cell, f"reference: {seconds:.1f}s; losses {ref.losses} and after the window "
                f"{late_ref.losses}, the program's {side.losses} and {late_side.losses}; "
                f"worst {where}")
    record["reference"] = {"t_to": [t for t, _ in setup[:checked]],
                           "late_t_to": [t for t, _ in late], "late_step": late_state["step"],
                           "losses": ref.losses + late_ref.losses,
                           "side_losses": side.losses + late_side.losses,
                           "seconds": seconds, "readings": values, "where": where}
    if witness is not None:
        record["reference"]["late_witness"] = witness
    ok, record["checks"] = judge(values, cell.limits)
    record["correct"] = ok and record["failed"] == 0
    return record


def control(cell, device: str, rounding: str = "fp8", after_window: bool = True) -> dict:
    """The control: the reference put in the program's place in float8
    operands (or another `rounding`), over the same checked steps, against
    the float32 reference -> its readings. With `after_window`, the checked pair
    after the window is the next pair drawn, which both follow from the
    float32 reference's LoRA and AdamW state after the first steps."""
    inputs = draw_inputs(cell, device)
    checked = cell.traffic["checked_steps"]
    setup = [(t_to, inputs.latents.next()) for _ in range(max(1, math.ceil(checked / 2)))
             for t_to in inputs.pairs.next_pair()][:checked]
    late = [(t_to, inputs.latents.next()) for t_to in inputs.pairs.next_pair()]
    model = reference_model(cell, device, inputs)
    lat, t_tos = [x for _, x in setup], [t for t, _ in setup]
    ref = follow(cell, model, inputs, inputs.lora_init, lat, t_tos)
    low = follow(cell, model, inputs, inputs.lora_init, lat, t_tos, rounding=rounding)
    values, where = readings(low, ref, inputs.lora_init)
    if not after_window:
        return {"t_to": t_tos, "losses": ref.losses, "control_losses": low.losses,
                "readings": values, "where": where}
    lat, t_tos = [x for _, x in late], [t for t, _ in late]
    late_ref = follow(cell, model, inputs, ref.params, lat, t_tos, state=ref.state)
    late_low = follow(cell, model, inputs, ref.params, lat, t_tos, rounding=rounding,
                      state=ref.state)
    late_values, late_where = readings(late_low, late_ref, ref.params)
    values.update({f"late.{k}": v for k, v in late_values.items()})
    where.update({f"late.{k}": v for k, v in late_where.items()})
    return {"t_to": [t for t, _ in setup], "late_t_to": t_tos,
            "losses": ref.losses + late_ref.losses,
            "control_losses": low.losses + late_low.losses, "readings": values, "where": where}
