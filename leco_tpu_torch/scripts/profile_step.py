"""Trace train steps on the card and break their device time down by
kernel, by category and by UNet component.

    python -m leco_tpu_torch.scripts.profile_step [--t_to 25] [--res 512] \
        [--attn flash|xla] [--remat] [--logdir DIR] [--top 40] [--device cuda]

Counterpart of `scripts/profile_step.py` (one SD1.5 train step, batch 1,
rank-4 LoRA, DDIM, AdamW, traced on the chip, device time by op category
and by op) with `scripts/attribute_fwd.py`'s component buckets. A warm
step, one unprofiled step for the wall clock, then `torch.profiler` over 2
steps at `--t_to`, the trace written to `<logdir>/trace.json` (Perfetto or
chrome://tracing). `analyze` reads the profiler's events:

  * device busy seconds a step, and the idle share against the unprofiled
    step's wall clock (the profiler slows the host down);
  * self device time by kernel (top N);
  * device time by category: the port's kernels 1-8 by their names, cuDNN
    convolutions, cuBLAS GEMMs, NCHW<->NHWC conversions, norms, softmax,
    reductions, copies and memsets, elementwise;
  * device time by UNet component, in `attribute_fwd.component_of`'s
    buckets (attn1/attn2 projections and core, resnet conv1/conv2/shortcut,
    norms, ff, ...): forward hooks that this script registers open a
    `record_function` scope around each bucket's module; the profiler puts
    each scope on the device timeline over the kernels launched inside it,
    and a kernel counts for the innermost scope that holds it. Kernels
    outside every UNet forward (the target's backward, the loss, the
    optimizer, the latents) count as "outside the UNet forward".

The JAX script's xplane parsing and `--analyze-only` have no counterpart.
`--device` defaults to cuda and raises without a GPU; a run that traces no
device time raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import tempfile
import time
from typing import Optional

import torch

SCOPE = "leco/"  # the prefix of this script's record_function scopes
OUTSIDE = "outside the UNet forward"
UNET_OTHER = "unet/other"

# (category, fragments of the kernel's name); the first match wins
CATEGORIES = (
    ("kernel 1/4 flash forward (3-d, packed)", ("flash_fwd_kernel",)),
    ("kernel 2 flash dQ", ("flash_bwd_dq_kernel",)),
    ("kernel 3 flash dK/dV", ("flash_bwd_dkv_kernel",)),
    ("kernel 5/6 conv3x3, gnconv3x3", ("conv3x3_kernel",)),
    ("kernel 5 conv3x3 weight repack", ("pack_weight_kernel",)),
    ("kernel 7 group_norm", ("group_norm_kernel",)),
    ("kernel 8 geglu", ("geglu_kernel",)),
    ("NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit_gemm")),
    ("cuBLAS GEMM", ("gemm", "nvjet", "cublas")),
    ("norms", ("norm", "Norm", "RowwiseMoments", "ComputeFusedParams", "welford")),
    ("softmax", ("softmax", "Softmax")),
    ("reductions", ("reduce_kernel",)),
    ("copies", ("Memcpy", "Memset", "copy_kernel", "CatArrayBatchedCopy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category_of(kernel_name: str) -> str:
    for category, fragments in CATEGORIES:
        if any(f in kernel_name for f in fragments):
            return category
    return "other"


_RESNET_LEAVES = {"conv1": "resnet/conv1", "conv2": "resnet/conv2",
                  "conv_shortcut": "resnet/shortcut", "time_emb_proj": "resnet/time_emb",
                  "norm1": "resnet/norm", "norm2": "resnet/norm"}
_TOP_LEVEL = {"conv_in": "conv_in/out", "conv_out": "conv_in/out",
              "conv_norm_out": "conv_in/out", "time_embedding": "time_embedding",
              "add_embedding": "time_embedding"}


def component_of(name: str) -> Optional[str]:
    """A UNet submodule's dotted name -> its bucket, the names of
    `scripts/attribute_fwd.py::component_of`, or None for a module that
    opens no scope of its own. (That function matches substrings of XLA op
    paths, which files the transformer blocks' norm1/norm2 under
    resnet/norm; here each module is placed by where it sits.)"""
    parts = name.split(".")
    leaf = parts[-1]
    for which, label in (("attn1", "attn1(self)"), ("attn2", "attn2(cross)")):
        if which in parts:
            if leaf == which:
                return f"{label}/core"
            if leaf in ("to_q", "to_k", "to_v"):
                return f"{label}/{leaf}"
            if parts[-2] == "to_out":  # to_out.0, the projection
                return f"{label}/to_out"
            return None
    if len(parts) == 1:
        return _TOP_LEVEL.get(leaf)
    parent = parts[-3] if len(parts) >= 3 else ""
    if parent == "resnets":
        return _RESNET_LEAVES.get(leaf)
    if leaf.isdigit() and parts[-2] in ("upsamplers", "downsamplers"):
        return "updown/sample"
    if parent == "attentions":
        return {"proj_in": "transformer/proj", "proj_out": "transformer/proj",
                "norm": "transformer/norm"}.get(leaf)
    if parent == "transformer_blocks":
        return {"ff": "transformer/ff", "norm1": "transformer/ln", "norm2": "transformer/ln",
                "norm3": "transformer/ln"}.get(leaf)
    return None


@contextlib.contextmanager
def component_scopes(unet: torch.nn.Module):
    """Inside the block every UNet forward opens a `record_function` scope
    "leco/<bucket>" around each bucket's module, and "leco/unet/other"
    around the whole forward."""
    handles = []
    open_scopes: dict[int, list] = collections.defaultdict(list)

    def add(module: torch.nn.Module, scope: str) -> None:
        def enter(mod, args):
            rf = torch.profiler.record_function(scope)
            rf.__enter__()
            open_scopes[id(mod)].append(rf)

        def leave(mod, args, output):
            open_scopes[id(mod)].pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))

    add(unet, SCOPE + UNET_OTHER)
    for name, module in unet.named_modules():
        bucket = component_of(name) if name else None
        if bucket is not None:
            add(module, SCOPE + bucket)
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()


def _span(event) -> tuple[float, float]:
    return event.time_range.start, event.time_range.end


def attribute(kernels: list, scopes: list) -> list[str]:
    """The bucket of each kernel: the innermost scope whose device span
    holds it (the scopes nest), or OUTSIDE."""
    order = sorted(range(len(kernels)), key=lambda i: _span(kernels[i])[0])
    scopes = sorted(scopes, key=lambda s: (_span(s)[0], -_span(s)[1]))
    out = [OUTSIDE] * len(kernels)
    stack: list = []
    j = 0
    for i in order:
        start, end = _span(kernels[i])
        while j < len(scopes) and _span(scopes[j])[0] <= start:
            while stack and _span(stack[-1])[1] < _span(scopes[j])[0]:
                stack.pop()
            stack.append(scopes[j])
            j += 1
        while stack and _span(stack[-1])[1] < end:
            stack.pop()
        if stack:
            out[i] = stack[-1].name[len(SCOPE):]
    return out


def analyze(events, wall_s: float, steps: int = 1, top: int = 30) -> dict:
    """The device time of `steps` train steps traced in `events` (a
    session's torch.profiler events, `kernels.timing.profiled`'s), a step's
    unprofiled wall clock `wall_s`:
    busy seconds and launches a step, the idle share, the top kernels, and
    the time by category and by UNet component (ms a step, share of busy).
    Raises when the profiler saw no device time."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.is_user_annotation]
    scopes = [e for e in device if e.is_user_annotation and e.name.startswith(SCOPE)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")

    by_kernel: dict = collections.defaultdict(lambda: [0.0, 0])
    by_category: dict = collections.Counter()
    by_component: dict = collections.Counter()
    for e, bucket in zip(kernels, attribute(kernels, scopes)):
        us = e.time_range.elapsed_us()
        by_kernel[e.name][0] += us
        by_kernel[e.name][1] += 1
        by_category[category_of(e.name)] += us
        by_component[bucket] += us

    def table(counter) -> dict:
        return {k: [us / steps / 1e3, us / busy_us] for k, us in counter.most_common()}

    busy_s = busy_us / steps / 1e6
    return {
        "steps": steps,
        "wall_s": wall_s,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "kernel_launches": len(kernels) / steps,
        "component_scopes": len(scopes) / steps,
        "top_kernels": [[name[:90], us / steps / 1e3, calls / steps] for name, (us, calls) in
                        sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]],
        "by_category_ms_share": table(by_category),
        "by_component_ms_share": table(by_component),
    }


def profile_steps(step, unet, device: torch.device, steps: int = 2,
                  logdir: Optional[str] = None) -> dict:
    """`step()` (one train step) once warm, once timed unprofiled, then
    `steps` times under torch.profiler with the UNet's component scopes, in
    a session that kept its records (`kernels.timing.profiled`: as many
    device records each step) ->
    `analyze`'s result; the trace goes to `<logdir>/trace.json`."""
    from leco_tpu_torch.kernels import timing

    def run() -> float:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    run()  # warm-up: cuDNN and cuBLAS pick their algorithms
    wall = run()
    with component_scopes(unet):
        prof, events = timing.profiled(step, device, calls=steps, alike=True)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return analyze(events, wall, steps)


def main(argv=None) -> dict:
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_sd15_bundle
    from leco_tpu_torch.train import trainer
    from leco_tpu_torch.train.optim import get_optimizer
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--t_to", type=int, default=25)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--attn", default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "leco_trace"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device to profile on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    attn = args.attn or default_backend(device)

    bundle = make_sd15_bundle(spec=LoRASpec(rank=4, alpha=1.0), attn_backend=attn,
                              device=device)
    bundle.unet.checkpoint_unet = args.remat
    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": args.res})
    pair = trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0]
    pack = trainer.build_pack(pair, False, args.res, args.res)
    optimizer = get_optimizer("adamw", list(bundle.lora_params.values()), 1e-4)
    step_fn = trainer.make_train_step(bundle, optimizer, 50)
    generator = torch.Generator(device)
    generator.manual_seed(0)

    def step():
        step_fn(pack, pair.guidance_scale, pair.erase_sign, args.t_to, height=args.res,
                width=args.res, generator=generator)

    result = profile_steps(step, bundle.unet, device, logdir=args.logdir)
    top = result.pop("top_kernels")
    print(f"device busy {result['device_busy_s'] * 1e3:.1f} ms a step, idle "
          f"{100 * result['device_idle_share']:.1f}% of the {result['wall_s'] * 1e3:.1f} ms "
          f"step, {result['kernel_launches']:.0f} launches (t_to {args.t_to})")
    for title, key in (("category", "by_category_ms_share"),
                       ("UNet component", "by_component_ms_share")):
        print(f"\n== by {title} ==")
        for name, (ms, share) in result[key].items():
            print(f"{ms:9.2f} ms  {100 * share:5.1f}%  {name}")
    print(f"\n== top {args.top} kernels ==")
    for name, ms, calls in top[:args.top]:
        name = re.sub(r"\s+", " ", name)
        print(f"{ms:9.2f} ms  {calls:7.0f}x  {name}")
    record = {"t_to": args.t_to, "res": args.res, "attn": attn, "remat": args.remat,
              "knobs": benchkit.knobs(), "device": benchkit.device_record(),
              "trace": os.path.join(args.logdir, "trace.json"), **result, "top_kernels": top}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
