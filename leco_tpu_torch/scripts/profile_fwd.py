"""Trace the bare UNet forward on the card (the inner-denoise body of a
train step, and the whole body of an inference step) and break its device
time down by kernel, by category and by UNet component.

    python -m leco_tpu_torch.scripts.profile_fwd [--res 512] [--batch 2] \
        [--attn flash|xla] [--model sd15|sdxl] [--logdir DIR] [--device cuda]

Counterpart of `scripts/profile_fwd.py`. The random bundle in bf16 with a
rank-4 LoRA folded into the base weights (`lora.folded_lora`, as the
inner-denoise loop folds it; the JAX script's `merge_params` keeps the
rank-4 branch, whose products are 0.025% of a step's), `checkpoint_unet`
off, attention as `--attn` says; latents (batch, 4, res/8, res/8) and
context (batch, 77, cross_attention_dim) from generators seeded 0 and 1,
and for SDXL the text_embeds zeros and the time_ids [res, res, 0, 0, res,
res]. One warm call, 10 calls chained `o = fwd(o)` for the wall time a
call, then `torch.profiler` over `n_calls` (4) chained calls with
`profile_step.component_scopes` open; the trace goes to
`<logdir>/trace.json`. The chained outputs of a random UNet may grow
without bound, as the JAX script's do: only the first call's output is
checked (finite).

`analyze` takes the place of the JAX script's xplane parser and is
`profile_step.analyze` over the calls: the device busy time a call and
the idle share against the wall time, the time by category, the top
kernels with their launches a call, and the time by UNet component (the
buckets of `scripts/attribute_fwd.py`; its join with optimized HLO text
has no counterpart in eager torch). `LECO_PROFILE_DUMP=<path>` writes every
kernel's and every component's ms a call as JSON. The fused-kernel knobs
(`LECO_FLASH_PACKED`, `LECO_CONV_BACKEND`, `LECO_RESNET_FUSED`,
`LECO_TPU_FUSED_GN`, `LECO_GEGLU`) route the forward as everywhere in the
port. `--device` defaults to cuda and raises without a GPU; a run that
traces no device time raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time
from typing import Optional

import torch

TIMESTEP = 500.0
TEXT_TOKENS = 77
WALL_CALLS = 10
N_CALLS = 4
TOP = 45  # kernels in the printed table and the record


def forward_inputs(config, res: int, batch: int, device, dtype: torch.dtype) -> tuple:
    """(latents, context, added conditions or None) of the profiled call:
    the latents and the context from generators seeded 0 and 1 on
    `device`; SDXL's text_embeds zeros of the pooled width and time_ids
    [res, res, 0, 0, res, res]."""
    h = res // 8

    def draw(shape, seed: int) -> torch.Tensor:
        gen = torch.Generator(device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    x = draw((batch, config.in_channels, h, h), 0)
    ctx = draw((batch, TEXT_TOKENS, config.cross_attention_dim), 1)
    added = None
    if config.addition_embed_type == "text_time":
        pooled = (config.projection_class_embeddings_input_dim
                  - 6 * config.addition_time_embed_dim)
        added = {"text_embeds": torch.zeros((batch, pooled), dtype=dtype, device=device),
                 "time_ids": torch.tensor([[res, res, 0, 0, res, res]], dtype=dtype,
                                          device=device).repeat(batch, 1)}
    return x, ctx, added


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture(unet, x, ctx, added, n_calls: int = N_CALLS,
            logdir: Optional[str] = None) -> dict:
    """The JAX script's `capture` on the port's UNet, with its LoRA folded:
    one warm call, WALL_CALLS chained calls timed by the host clock after
    a synchronize, then `n_calls` chained calls under torch.profiler with
    the component scopes open, in a session that kept its records
    (`kernels.timing.profiled`: as many device records each call; the
    trace to `<logdir>/trace.json`).
    -> {"first": the first call's output, "wall_s": seconds a call,
    "calls": calls made, "events": the session's events}."""
    from leco_tpu_torch.kernels import timing
    from leco_tpu_torch.lora import folded_lora
    from leco_tpu_torch.scripts.profile_step import component_scopes

    device = x.device
    calls = [0]
    carry = {"o": x, "n": 0}

    def fwd(o):
        calls[0] += 1
        return unet(o, TIMESTEP, ctx, added)

    def traced():  # a session that is taken again starts from x again
        if carry["n"] % n_calls == 0:
            carry["o"] = x
        carry["o"] = fwd(carry["o"])
        carry["n"] += 1

    with torch.no_grad(), folded_lora(unet):
        first = fwd(x)
        _synchronize(device)
        t0 = time.perf_counter()
        o = x
        for _ in range(WALL_CALLS):
            o = fwd(o)
        _synchronize(device)
        wall_s = (time.perf_counter() - t0) / WALL_CALLS
        with component_scopes(unet):
            prof, events = timing.profiled(traced, device, calls=n_calls, alike=True)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return {"first": first, "wall_s": wall_s, "calls": calls[0], "events": events}


def analyze(events, n_calls: int, wall_s: float) -> dict:
    """`profile_step.analyze` of `n_calls` traced forwards, every kernel
    kept: busy seconds, launches and scopes a call, the idle share against
    `wall_s`, and the time by kernel, category and component (ms a call,
    share of busy). Prints the tables (the top TOP kernels); with
    LECO_PROFILE_DUMP set, writes {"kernels": {name: ms a call},
    "components": {bucket: ms a call}} there. Raises when the profiler saw
    no device time."""
    from leco_tpu_torch.scripts import profile_step

    result = profile_step.analyze(events, wall_s, steps=n_calls, top=None)
    result["profiled_calls"] = result.pop("steps")
    print(f"\ndevice busy {result['device_busy_s'] * 1e3:.3f} ms/call, idle "
          f"{100 * result['device_idle_share']:.1f}% of the {wall_s * 1e3:.3f} ms call, "
          f"{result['kernel_launches']:.0f} launches/call")
    for title, key in (("category", "by_category_ms_share"),
                       ("UNet component", "by_component_ms_share")):
        print(f"\n== by {title} (per call) ==")
        for name, (ms, share) in result[key].items():
            print(f"{ms:9.3f} ms  {100 * share:5.1f}%  {name}")
    print(f"\n== top {TOP} kernels (per call) ==")
    busy_ms = result["device_busy_s"] * 1e3
    for name, ms, calls in result["top_kernels"][:TOP]:
        name = re.sub(r"\s+", " ", name)
        print(f"{ms:8.3f} ms  {100 * ms / busy_ms:4.1f}%  x{calls:<5g} {name[:100]}")
    dump = os.environ.get("LECO_PROFILE_DUMP")
    if dump:
        kernels: dict = {}
        for name, ms, _ in result["top_kernels"]:  # names cut to 90 characters may repeat
            kernels[name] = kernels.get(name, 0.0) + ms
        with open(dump, "w") as f:
            json.dump({"kernels": kernels,
                       "components": {name: ms for name, (ms, _) in
                                      result["by_component_ms_share"].items()}}, f)
        print(f"per-kernel and per-component times written to {dump}")
    return result


def make_bundle(model: str, attn: str, device):
    """The random bundle of `model` ("sd15" or "sdxl") in bf16 with a
    rank-4 LoRA, `checkpoint_unet` off."""
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.models.unet import sd15_config, sdxl_config
    from leco_tpu_torch.testing import make_random_bundle

    config = {"sd15": sd15_config, "sdxl": sdxl_config}[model]()
    bundle = make_random_bundle(config=config, spec=LoRASpec(rank=4), dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16, attn_backend=attn, device=device)
    bundle.unet.checkpoint_unet = False
    return bundle


def main(argv=None, bundle=None) -> dict:
    """Profile the forward of `--model`'s random bundle (or of `bundle`'s
    UNet, in its own dtype), print the tables and one JSON record, and
    return it."""
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--attn", choices=["flash", "xla"], default="flash")
    ap.add_argument("--model", choices=["sd15", "sdxl"], default="sd15")
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "leco_fwd_trace"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to profile on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if bundle is None:
        bundle = make_bundle(args.model, args.attn, device)
    else:
        bundle.unet.set_attention_backend(args.attn)
    unet = bundle.unet
    x, ctx, added = forward_inputs(unet.cfg, args.res, args.batch, device, unet.dtype)
    run = capture(unet, x, ctx, added, N_CALLS, args.logdir)
    first = run["first"]
    finite = bool(torch.isfinite(first).all())
    print(f"fwd wall: {run['wall_s'] * 1e3:.2f} ms/call (batch={args.batch}, {args.res}px, "
          f"attn={args.attn}, model={args.model}); first output finite: {finite}", flush=True)
    result = analyze(run["events"], N_CALLS, run["wall_s"])
    record = {"model": args.model, "res": args.res, "batch": args.batch, "attn": args.attn,
              "calls": run["calls"],
              "first_output_shape": list(first.shape), "first_output_finite": finite,
              "knobs": benchkit.knobs(), "backend_flags": benchkit.backend_flags(),
              "platform": benchkit.platform(device),
              "device": benchkit.device_record() if device.type == "cuda" else None,
              "trace": os.path.join(args.logdir, "trace.json"),
              "wall_ms_per_call": run["wall_s"] * 1e3, **result}
    record["top_kernels"] = record["top_kernels"][:TOP]
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
