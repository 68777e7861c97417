"""The traced pair: one antithetic pair of iterations under torch.profiler
(CPU and CUDA activities, kept in memory, no trace file), read into the
numbers the per-layer metrics take.

Frozen here from the program's profiling script (so that a later change of
the program cannot move the yardstick): the kernel categories
(`CATEGORIES`, first match wins), the UNet component buckets
(`component_of`) and the scopes that forward hooks open around each
bucket's module from outside the program (`component_scopes`), and the
innermost-scope attribution (`attribute`).

A kernel counts for the innermost scope whose host-side range holds the
moment its launch was issued (the runtime call that CUPTI correlates with
it); kernels of the target's backward, the loss, the optimizer and the
latents count as outside every UNet forward. The profiler can drop device
records (most often the first of a session), so the session starts with a
lead (tiny kernels and a spin of about 10 ms, then a synchronize) and
brackets the pair between two marker kernels; only device records between
the markers count, and a session without both markers is taken again.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Callable, Optional

import numpy as np

SCOPE = "bench/"
OUTSIDE = "outside the UNet forward"
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_MAX_NS = 100_000
LEAD_KERNELS, LEAD_CYCLES = 64, 20_000_000
ATTEMPTS = 3
TOP = 10

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
CORE_BUCKETS = ("attn1(self)/core", "attn2(cross)/core")


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
    """A UNet submodule's dotted (diffusers) name -> its bucket, or None for
    a module that opens no scope of its own."""
    parts = name.split(".")
    leaf = parts[-1]
    for which, label in (("attn1", "attn1(self)"), ("attn2", "attn2(cross)")):
        if which in parts:
            if leaf == which:
                return f"{label}/core"
            if leaf in ("to_q", "to_k", "to_v"):
                return f"{label}/{leaf}"
            if parts[-2] == "to_out":
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
def component_scopes(unet):
    """Inside the block every forward of `unet` opens a `record_function`
    scope "bench/<bucket>" around each bucket's module, and
    "bench/unet/other" around the whole forward."""
    import torch

    handles = []
    open_scopes: dict = collections.defaultdict(list)

    def add(module, scope: str) -> None:
        def enter(mod, args):
            rf = torch.profiler.record_function(scope)
            rf.__enter__()
            open_scopes[id(mod)].append(rf)

        def leave(mod, args, output):
            open_scopes[id(mod)].pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))

    add(unet, SCOPE + "unet/other")
    for name, module in unet.named_modules():
        bucket = component_of(name) if name else None
        if bucket is not None:
            add(module, SCOPE + bucket)
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()


def attribute(points: list, scopes: list) -> list:
    """The bucket of each time point: the innermost scope (start, end, name)
    that holds it (the scopes nest), or OUTSIDE."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    scopes = sorted(scopes, key=lambda s: (s[0], -s[1]))
    out = [OUTSIDE] * len(points)
    stack: list = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(scopes) and scopes[j][0] <= p:
            while stack and stack[-1][1] < scopes[j][0]:
                stack.pop()
            stack.append(scopes[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if stack:
            out[i] = stack[-1][2][len(SCOPE):]
    return out


def _lead_and_mark(torch) -> None:
    x = torch.zeros(1, device="cuda")
    for _ in range(LEAD_KERNELS):
        x.add_(1)
    torch.cuda._sleep(LEAD_CYCLES)
    torch.cuda.synchronize()
    torch.cuda._sleep(1)


def _annotation(e) -> bool:
    """A `record_function` range shown on the device timeline, not work."""
    activity = getattr(e, "activity_type", lambda: "")()
    return e.is_user_annotation() or "annotation" in activity or e.name().startswith(SCOPE)


def profile_pair(run_pair: Callable[[], None], unet) -> dict:
    """`run_pair()` (two iterations, each ending in its loss fetch) under
    the profiler with the UNet's component scopes -> the session's records
    between the markers and the pair's wall seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(ATTEMPTS):
        with component_scopes(unet), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _lead_and_mark(torch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_pair()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        device, cpu = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                device.append(e)
            else:
                cpu.append(e)
        markers = [e for e in device if MARKER in e.name() and e.duration_ns() < MARKER_MAX_NS
                   and not _annotation(e)]
        if len(markers) == 2:
            lo = markers[0].start_ns() + markers[0].duration_ns()
            hi = markers[1].start_ns()
            kept = [e for e in device if lo <= e.start_ns() < hi and not _annotation(e)]
            if kept:
                return {"device": kept, "cpu": cpu, "wall_s": wall}
    raise RuntimeError(f"the profiler lost device records in {ATTEMPTS} sessions")


def _union(intervals: list) -> tuple[float, list]:
    """(covered nanoseconds, [(gap start, gap end)]) of sorted intervals."""
    covered, gaps = 0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            covered += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered, gaps


def analyze(session: dict, iterations: int) -> dict:
    """The traced pair's numbers: device operations (count and busy time),
    the union of device activity against the wall time, device time by
    kernel, category and UNet component, and the longest idle gaps named
    by the host-side operation that issued the launch ending each."""
    device, cpu = session["device"], session["cpu"]
    runtime_start = {}
    frontend = {}
    scopes = []
    for e in cpu:
        if e.linked_correlation_id() > 0:  # a runtime or driver call, linked to its op
            runtime_start[e.correlation_id()] = e.start_ns()
        else:
            frontend[e.correlation_id()] = e
            if e.is_user_annotation() and e.name().startswith(SCOPE):
                scopes.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    launches = []
    for e in device:
        t = runtime_start.get(e.correlation_id())
        if t is None:
            op = frontend.get(e.linked_correlation_id())
            t = op.start_ns() if op is not None else e.start_ns()
        launches.append(t)
    buckets = attribute(launches, scopes)

    by_kernel: dict = collections.defaultdict(lambda: [0, 0])
    by_category: dict = collections.Counter()
    by_component: dict = collections.Counter()
    intervals = []
    for e, bucket in zip(device, buckets):
        ns = e.duration_ns()
        by_kernel[e.name()][0] += ns
        by_kernel[e.name()][1] += 1
        by_category[category_of(e.name())] += ns
        by_component[bucket] += ns
        intervals.append((e.start_ns(), e.start_ns() + ns))
    order = sorted(range(len(device)), key=lambda i: intervals[i][0])
    busy_ns, gaps = _union([intervals[i] for i in order])

    # name each of the longest gaps by the host op behind the launch that ends it
    starts = [intervals[i][0] for i in order]
    cpu_ops = [e for e in frontend.values() if not e.is_user_annotation()]
    op_start = np.array([e.start_ns() for e in cpu_ops], dtype=np.int64)
    op_end = op_start + np.array([e.duration_ns() for e in cpu_ops], dtype=np.int64)
    idle = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        nxt = order[bisect.bisect_left(starts, g1)]
        launch = launches[nxt]
        inside = np.nonzero((op_start <= launch) & (op_end >= launch))[0]
        op = cpu_ops[inside[np.argmax(op_start[inside])]].name() if len(inside) else "python"
        idle.append([f"{buckets[nxt]} > {op} > {device[nxt].name()[:60]}", (g1 - g0) / 1e9])

    ms = 1e-6
    return {
        "iterations": iterations,
        "wall_s": session["wall_s"],
        "busy_s": busy_ns / 1e9,
        "launches": len(device),
        "by_category_ms": {k: v * ms for k, v in by_category.most_common()},
        "by_component_ms": {k: v * ms for k, v in by_component.most_common()},
        "core_ms": sum(by_component.get(b, 0) for b in CORE_BUCKETS) * ms,
        "device_ops": [[name, ns / 1e9] for name, (ns, _) in
                       sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "idle_gaps": idle,
    }
