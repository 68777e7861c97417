"""Rank workers for the multi-process checks of the parallel step.

`spawn(job, world_size, workdir)` runs one job on `world_size` fresh
processes (torch.multiprocessing's spawn, gloo over a `file://` store in
`workdir`, so that concurrent runs share no port) and returns each rank's
result; `Running(...)` starts them and its `results()` waits, so that the
caller may work meanwhile. The children import this module, torch, numpy and the port only:
each result lists the modules of JAX, the JAX package or the tests that its
process holds (`foreign_modules`), which must be none.

Jobs (`job["kind"]`):
  * "ops": each sharded layer of `parallel/` (the halo convs, the sp
    GroupNorm and attention, the tp Linears, GEGLU included) forward and
    backward beside the same layer unsharded on the same inputs;
  * "knob_ops": the same for the fused-kernel knobs' routes (the row-window
    conv and GroupNorm-SiLU-conv, the split GroupNorm, packed attention over
    sp; packed attention and GEGLU under tp), each with its kernels' calls,
    and the two controls that must fail;
  * "steps": one train step per entry of `job["steps"]` on the mesh it
    names, from the weights, pack and latents of its case, with the knobs
    it names set (`knobs`) and, with `open_gates`, the 128-channel floors of
    the conv gates lowered to 1 for a tiny model -> loss, LoRA gradients,
    LoRA after the step, kernel calls (the kernels' launches on CUDA, their
    plain versions' calls on the CPU);
  * "seed": `shared_seed(None)` and the draws of the run's generators;
  * "resume": a sharded `train()` run, whole and interrupted then resumed.

Ranks may share one device (`job["device"]`): the chip's phase runs every
rank on `cuda:0` over gloo, which takes CUDA tensors.
"""

from __future__ import annotations

import contextlib
import datetime
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F

FOREIGN = ("jax", "jaxlib", "flax", "optax", "leco_tpu", "tests")
FLASH_PLAIN = ("attn_fwd_plain", "attn_bwd_dq_plain", "attn_bwd_dkv_plain")
# each kernel module of `leco_tpu_torch.ops` -> its kernels' plain versions
PLAIN = {
    "flash_attention": FLASH_PLAIN + ("attn_fwd_packed_plain",),
    "conv": ("conv3x3_gemm_plain", "conv3x3_rows_plain"),
    "gn_conv": ("gnconv3x3_plain", "gnconv3x3_rows_plain"),
    "group_norm": ("group_norm_silu_plain", "group_norm_stats_plain", "group_norm_apply_plain"),
    "geglu": ("geglu_gemm_plain",),
}
# the two controls of the knobs' sp routes, each of which must fail the check
KNOB_CONTROLS = ("gnconv_edge_unmasked", "gn_stats_local")


class Running:
    """A job's rank processes, started; `results()` waits for them."""

    def __init__(self, job: dict, world_size: int, workdir):
        self.workdir, self.world_size = Path(workdir), world_size
        self.workdir.mkdir(parents=True, exist_ok=True)
        torch.save(job, self.workdir / "job.pt")
        self.context = torch.multiprocessing.spawn(
            _entry, args=(world_size, str(self.workdir)), nprocs=world_size, join=False)

    def results(self) -> list[dict]:
        while not self.context.join():  # raises a rank's exception, with its traceback
            pass
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world_size)]


def spawn(job: dict, world_size: int, workdir) -> list[dict]:
    return Running(job, world_size, workdir).results()


def _entry(rank: int, world_size: int, workdir: str) -> None:
    job = torch.load(Path(workdir) / "job.pt", weights_only=False)
    torch.set_num_threads(job.get("threads", 1))
    if str(job.get("device", "cpu")).startswith("cuda"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=job.get("timeout", 300)))
    try:
        result = JOBS[job["kind"]](job)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    result["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    torch.save(result, Path(workdir) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


@contextlib.contextmanager
def counting_kernels():
    """Count every kernel's calls: each kernel wrapper's launches on CUDA
    (`launches_<wrapper>`), each plain version's calls on the CPU (what the
    wrappers run there) -> {name: count}, filled when the block ends."""
    import importlib

    from leco_tpu_torch.kernels import launch

    modules = {m: importlib.import_module(f"leco_tpu_torch.ops.{m}") for m in PLAIN}
    counts = {name: 0 for names in PLAIN.values() for name in names}

    def counted(real, name):
        def fn(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        return fn

    wrappers = [w for mod in modules.values() for w in mod.KERNEL_WRAPPERS]
    launch.reset(wrappers)
    with contextlib.ExitStack() as stack:
        for m, names in PLAIN.items():
            mod = modules[m]
            stack.enter_context(patched(mod, **{n: counted(getattr(mod, n), n) for n in names}))
        yield counts
    counts.update({f"launches_{k}": v for k, v in launch.counts(wrappers).items()})


# the eight kernels -> the wrappers that launch each: a row window is the
# same kernel's other entry, and a split GroupNorm counts once (its apply
# launch; its statistics launch runs as often)
KERNEL_ENTRIES = {
    "attn_fwd": ("attn_fwd",), "attn_bwd_dq": ("attn_bwd_dq",),
    "attn_bwd_dkv": ("attn_bwd_dkv",), "attn_fwd_packed": ("attn_fwd_packed",),
    "conv3x3": ("conv3x3_gemm", "conv3x3_rows"),
    "gnconv3x3": ("gnconv3x3", "gnconv3x3_rows"),
    "group_norm": ("group_norm_silu", "group_norm_apply"),
    "geglu": ("geglu_gemm",),
}


def per_kernel(calls: dict, plain: bool = False) -> dict:
    """`counting_kernels`' counts -> each kernel's launches, or with
    `plain` its plain versions' calls."""
    key = "{}_plain" if plain else "launches_{}"
    return {k: sum(calls[key.format(w)] for w in ws) for k, ws in KERNEL_ENTRIES.items()}


def controls(name):
    """A control's fault: "kv_local" replaces the sp K/V gather by the
    rank's own rows (local-only attention), "halo_zero" zeroes the halo,
    "gnconv_edge_unmasked" sends the zero halo rows past the image's edges
    through the GroupNorm-SiLU-conv's activation, "gn_stats_local" leaves
    the GroupNorm kernel's statistics unreduced over sp."""
    from leco_tpu_torch.parallel import spatial

    if name == "kv_local":
        return patched(spatial, gather_seq=lambda x, par: x)
    if name == "halo_zero":
        return patched(spatial, halo_rows=lambda x, par: F.pad(x, (0, 0, 1, 1)))
    if name == "gnconv_edge_unmasked":
        return patched(spatial, edge_rows=lambda par: (True, True))
    if name == "gn_stats_local":
        return patched(spatial, reduce_group_sums=lambda sums, count, par: (sums, count))
    return contextlib.nullcontext()


def open_gates():
    """The conv kernels' 128-channel floors lowered to 1, so that a tiny
    model's convs take the knobs' kernel routes (the JAX package's tests
    open its gates alike); the gnconv gate's 4 <= H, W <= 16 stays."""
    from leco_tpu_torch.ops import conv, gn_conv

    stack = contextlib.ExitStack()
    stack.enter_context(patched(conv, HOT_MIN_CHANNELS=1))
    stack.enter_context(patched(gn_conv, MIN_FUSED_CHANNELS=1))
    return stack


def global_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    from leco_tpu_torch.parallel import collectives as C

    return C.all_gather(x.detach(), dim, group)


def rows(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    h = x.shape[dim] // n
    return x.narrow(dim, index * h, h).contiguous()


# ---------------------------------------------------------------------------
# "ops": the sharded layers against the unsharded ones
# ---------------------------------------------------------------------------


def _check_layer(make, x_global, grad_out, shard, unshard, ctx, reduce) -> dict:
    """Forward and backward of `make()` unsharded and sharded over sp ->
    {"got", "want"} of the output, the input's gradient and the parameters'.
    `shard(x)` is this rank's rows, `unshard(y)` the global tensor from
    them; `reduce(grads)` sums the parameters' gradients over the ranks."""
    from leco_tpu_torch.parallel.context import attach

    ref = make()
    x = x_global.clone().requires_grad_(True)
    y = ref(x)
    (y.float() * grad_out).sum().backward()
    want = {"y": y.detach(), "dx": x.grad,
            **{f"d_{k}": p.grad for k, p in ref.named_parameters() if p.grad is not None}}

    mod = make()
    attach(mod, ctx)
    xl = shard(x_global).requires_grad_(True)
    ctx.spatial = True
    try:
        yl = mod(xl)
    finally:
        ctx.spatial = False
    (yl.float() * shard(grad_out)).sum().backward()
    grads = {f"d_{k}": p.grad for k, p in mod.named_parameters() if p.grad is not None}
    reduce(list(grads.values()))
    got = {"y": unshard(yl.detach()), "dx": unshard(xl.grad), **grads}
    return {"got": {k: got.get(k) for k in want}, "want": want}


def _in_transformer(layer: torch.nn.Module, seed: int) -> torch.nn.Module:
    """`layer` inside an `attentions` list, where the LoRA spec applies,
    with a rank-2 LoRA whose `lora_up` is a seeded draw -> the holder."""
    from leco_tpu_torch.lora import LoRASpec, apply_lora_spec

    holder = torch.nn.Module()
    holder.attentions = torch.nn.ModuleList([layer])
    apply_lora_spec(holder, LoRASpec(rank=2, alpha=1.0), torch.Generator().manual_seed(seed))
    perturb_lora_(holder, seed, scale=0.3)
    return holder


def run_ops(job: dict) -> dict:
    from leco_tpu_torch.lora import LoRAConv2d, LoRASpec, lora_layers, lora_mode
    from leco_tpu_torch.models import unet as U
    from leco_tpu_torch.parallel import collectives as C
    from leco_tpu_torch.parallel import sharding
    from leco_tpu_torch.parallel.context import CallPlan, ParallelContext, attach
    from leco_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS, ProcessMesh

    device = torch.device(job.get("device", "cpu"))
    n, r = dist.get_world_size(), dist.get_rank()
    sp_mesh = ProcessMesh(SP_AXIS, n, device)
    tp_mesh = ProcessMesh(TP_AXIS, n, device)
    sp_ctx = ParallelContext(sp_mesh, levels=1)
    tp_ctx = ParallelContext(tp_mesh, levels=1)
    sp_group = sp_mesh.group(SP_AXIS)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def sum_sp(grads):
        C.sum_tensors(grads, sp_group)

    def sharded_dim(dim):
        return (lambda x: rows(x, dim, r, n)), (lambda y: global_rows(y, dim, sp_group))

    out = {}
    # the 3x3 convs with their c3lier LoRA branch: H 8 = 4 rows a rank
    conv_spec = LoRASpec(rank=2, alpha=1.0, network_type="c3lier")

    def lora_conv(mode="on", **kw):
        def make():
            conv = LoRAConv2d(8, 8, 3, padding=1, **kw)
            g = torch.Generator().manual_seed(2)
            conv.weight.data = torch.randn(conv.weight.shape, generator=g) * 0.2
            conv.bias.data = torch.randn(conv.bias.shape, generator=g) * 0.1
            conv.add_lora(conv_spec, g)
            conv.lora_up.data = torch.randn(conv.lora_up.shape, generator=g) * 0.2
            conv.to(device)
            conv.mode = mode
            if mode == "folded":  # the inner loop's phase convolutions
                conv.fold()
            return conv
        return make

    x = randn(2, 8, 8, 6)
    shard_h, gather_h = sharded_dim(2)
    for name, make, out_shape in (
        ("conv_stride1", lora_conv(), (2, 8, 8, 6)),
        ("conv_stride2", lora_conv(stride=2), (2, 8, 4, 3)),
        ("upsample_phase", lora_conv("folded", pre_upsample=True), (2, 8, 16, 12)),
        ("upsample_lora_on", lora_conv(pre_upsample=True), (2, 8, 16, 12)),
    ):
        out[name] = _check_layer(make, x, randn(*out_shape), shard_h, gather_h, sp_ctx, sum_sp)

    def group_norm():
        norm = U.GroupNorm(4, 8, 1e-5, silu=True)
        g = torch.Generator().manual_seed(3)
        norm.weight.data = 1 + 0.1 * torch.randn(8, generator=g)
        norm.bias.data = 0.1 * torch.randn(8, generator=g)
        return norm.to(device)

    out["group_norm"] = _check_layer(group_norm, x * 3 + 1, randn(2, 8, 8, 6), shard_h,
                                     gather_h, sp_ctx, sum_sp)

    # attention over 256 tokens (16 x 16), 2 heads of 4: each rank holds 128
    # query rows, which the dispatch sends to the kernels on the global 256
    tokens, text = randn(2, 256, 8), randn(2, 77, 8)
    shard_t, gather_t = sharded_dim(1)

    def attention(backend, cross):
        def make():
            torch.manual_seed(4)
            attn = U.Attention(8, 2, ctx_dim=8 if cross else None, backend=backend)
            for p in attn.parameters():
                torch.nn.init.normal_(p, std=0.3)
            holder = _in_transformer(attn, 5).to(device)
            if not cross:
                return holder.attentions[0]

            class Cross(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.attn = holder.attentions[0]

                def forward(self, q):
                    return self.attn(q, text)
            return Cross()
        return make

    for name, backend, cross, env in (
        ("attention_flash", "flash", False, {}),
        ("attention_plain", "xla", False, {}),
        ("attention_flash_plain_backward", "flash", False, {"LECO_FLASH_BWD": "xla"}),
        ("cross_attention_flash_cross", "flash", True, {"LECO_FLASH_CROSS": "1"}),
    ):
        with _environ(env), counting_kernels() as calls:
            out[name] = _check_layer(attention(backend, cross), tokens, randn(2, 256, 8),
                                     shard_t, gather_t, sp_ctx, sum_sp)
        out[name]["calls"] = dict(calls)

    # tp: a transformer whose heads divide tp (every layer sharded) and one
    # with 3 heads (its attention replicated, its feed-forward sharded)
    ctx_text = randn(2, 77, 8)
    for name, ch, heads, use_linear in (("tp_transformer", 8, 2, False),
                                        ("tp_transformer_odd_heads", 6, 3, True)):
        def make(ch=ch, heads=heads, use_linear=use_linear):
            torch.manual_seed(7)
            block = U.Transformer2DModel(ch, heads, 1, 8, 2, use_linear, False, "xla")
            for p in block.parameters():
                torch.nn.init.normal_(p, std=0.3)
            return _in_transformer(block, 8).to(device)

        x_img, g_img = randn(2, ch, 4, 4), randn(2, ch, 4, 4)
        result = {}
        for side in ("want", "got"):
            holder = make()
            if side == "got":
                result["plan"] = sharding.shard_unet(holder, tp_mesh)
                attach(holder, tp_ctx)
            xs = x_img.clone().requires_grad_(True)
            ys = holder.attentions[0](xs, ctx_text)
            (ys * g_img).sum().backward()
            if side == "got":
                tp_ctx.reduce_lora_grads(lora_layers(holder), CallPlan(False, False))
            # the inner loop's folded weights: each rank folds its own share
            with torch.no_grad(), lora_mode(holder, "folded"):
                for _, layer in lora_layers(holder):
                    layer.fold()
                folded = holder.attentions[0](x_img, ctx_text)
            result[side] = {"y": ys.detach(), "dx": xs.grad, "folded": folded,
                            **{k: p.grad for k, p in holder.named_parameters()
                               if ".lora_" in k}}
        out[name] = result
    return out


def run_knob_ops(job: dict) -> dict:
    """The fused knobs' routes of `parallel/`, each beside the same layer
    unsharded on the same inputs (`_check_layer`) with the kernels' calls
    of both sides together: under sp (H 8, 4 rows a rank) the row-window
    conv (c3lier LoRA branch on), a resnet block on GroupNorm-SiLU-conv, the
    split GroupNorm, self-attention over 256 tokens on the packed kernel;
    under tp a transformer over 256 tokens with packed attention, the GEGLU
    kernel and the GroupNorm kernel; the two controls of `KNOB_CONTROLS`."""
    from leco_tpu_torch.lora import LoRAConv2d, LoRASpec, lora_layers
    from leco_tpu_torch.models import unet as U
    from leco_tpu_torch.parallel import collectives as C
    from leco_tpu_torch.parallel import sharding
    from leco_tpu_torch.parallel.context import CallPlan, ParallelContext, attach
    from leco_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS, ProcessMesh

    device = torch.device(job.get("device", "cpu"))
    n, r = dist.get_world_size(), dist.get_rank()
    sp_mesh, tp_mesh = ProcessMesh(SP_AXIS, n, device), ProcessMesh(TP_AXIS, n, device)
    sp_ctx, tp_ctx = ParallelContext(sp_mesh, levels=1), ParallelContext(tp_mesh, levels=1)
    sp_group = sp_mesh.group(SP_AXIS)
    gen = torch.Generator().manual_seed(10)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def sum_sp(grads):
        C.sum_tensors(grads, sp_group)

    def check(make, x, grad_out, dim, env, control=None):
        shard = lambda t: rows(t, dim, r, n)  # noqa: E731
        unshard = lambda t: global_rows(t, dim, sp_group)  # noqa: E731
        with _environ(env), open_gates(), controls(control), counting_kernels() as calls:
            result = _check_layer(make, x, grad_out, shard, unshard, sp_ctx, sum_sp)
        return {**result, "calls": dict(calls)}

    def seeded(module, seed, std=0.3):
        torch.manual_seed(seed)
        for p in module.parameters():
            torch.nn.init.normal_(p, std=std)
        return module

    def lora_conv():
        conv = seeded(LoRAConv2d(8, 8, 3, padding=1), 11, 0.2)
        g = torch.Generator().manual_seed(12)
        conv.add_lora(LoRASpec(rank=2, alpha=1.0, network_type="c3lier"), g)
        conv.lora_up.data = torch.randn(conv.lora_up.shape, generator=g) * 0.2
        return conv.to(device)

    temb = randn(2, 16)

    class Resnet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = seeded(U.ResnetBlock2D(8, 8, 16, 4), 13, 0.2)
            for norm in (self.block.norm1, self.block.norm2):
                norm.weight.data += 1.0

        def forward(self, x):
            return self.block(x, temb)

    def group_norm():
        norm = seeded(U.GroupNorm(4, 8, 1e-5, silu=True), 14, 0.1)
        norm.weight.data += 1.0
        return norm.to(device)

    def attention():
        holder = _in_transformer(seeded(U.Attention(8, 2, backend="flash"), 15), 16)
        return holder.to(device).attentions[0]

    x = randn(2, 8, 8, 6)
    out = {
        "conv_gemm": check(lora_conv, x, randn(2, 8, 8, 6), 2, {"LECO_CONV_BACKEND": "gemm"}),
        "resnet_gnconv": check(lambda: Resnet().to(device), x, randn(2, 8, 8, 6), 2,
                               {"LECO_RESNET_FUSED": "1"}),
        "group_norm_fused": check(group_norm, x * 3 + 1, randn(2, 8, 8, 6), 2,
                                  {"LECO_TPU_FUSED_GN": "1"}),
        "attention_packed": check(attention, randn(2, 256, 8), randn(2, 256, 8), 1,
                                  {"LECO_FLASH_PACKED": "1"}),
        "control_gnconv_edge_unmasked": check(lambda: Resnet().to(device), x,
                                              randn(2, 8, 8, 6), 2, {"LECO_RESNET_FUSED": "1"},
                                              "gnconv_edge_unmasked"),
        "control_gn_stats_local": check(group_norm, x * 3 + 1, randn(2, 8, 8, 6), 2,
                                        {"LECO_TPU_FUSED_GN": "1"}, "gn_stats_local"),
    }

    # tp 2: 2 heads of 4 over 16 x 16 = 256 tokens, so self-attention takes
    # the packed kernel on each rank's head; the GEGLU kernel on the rank's
    # [value | gate] share; the GroupNorm kernel replicated
    knobs = {"LECO_FLASH_PACKED": "1", "LECO_GEGLU": "fused", "LECO_TPU_FUSED_GN": "1"}
    x_img, g_img, text = randn(2, 8, 16, 16), randn(2, 8, 16, 16), randn(2, 77, 8)
    result = {}
    for side in ("want", "got"):
        block = seeded(U.Transformer2DModel(8, 2, 1, 8, 2, False, False, "flash"), 17)
        holder = _in_transformer(block, 18).to(device)
        if side == "got":
            result["plan"] = sharding.shard_unet(holder, tp_mesh)
            attach(holder, tp_ctx)
        xs = x_img.clone().requires_grad_(True)
        with _environ(knobs), counting_kernels() as calls:
            ys = holder.attentions[0](xs, text)
            (ys * g_img).sum().backward()
        if side == "got":
            tp_ctx.reduce_lora_grads(lora_layers(holder), CallPlan(False, False))
        result[side] = {"y": ys.detach(), "dx": xs.grad,
                        **{k: p.grad for k, p in holder.named_parameters() if ".lora_" in k}}
        result[f"calls_{side}"] = dict(calls)
    out["tp_transformer_knobs"] = result
    return out


@contextlib.contextmanager
def _environ(values: dict):
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# "steps": one train step per mesh
# ---------------------------------------------------------------------------


def build_unet(case: dict, device):
    """The case's UNet with its LoRA: from `case["state"]` (a state dict)
    or, with `case["seed"]`, the random full-width bundle of
    `leco_tpu_torch.testing` with its lora_up perturbed by `perturb_lora_`."""
    from leco_tpu_torch.lora import LoRASpec, apply_lora_spec, lora_parameters
    from leco_tpu_torch.models.unet import UNet2DConditionModel

    spec = case.get("spec", LoRASpec(rank=4, alpha=1.0))
    if "state" in case:
        unet = UNet2DConditionModel(case["config"], dtype=case.get("dtype", torch.float32),
                                    attn_backend=case.get("backend", "flash"))
        apply_lora_spec(unet, spec, torch.Generator())
        unet.load_state_dict(case["state"])
        unet.to(device)
        unet.requires_grad_(False)
        for p in lora_parameters(unet).values():
            p.requires_grad_(True)
        return unet, spec
    from leco_tpu_torch.testing import make_random_bundle

    bundle = make_random_bundle(config=case["config"], spec=spec, dtype=case["dtype"],
                                param_dtype=case["dtype"], seed=case["seed"], device=device)
    perturb_lora_(bundle.unet, case["seed"])
    return bundle.unet, spec


@torch.no_grad()
def perturb_lora_(unet, seed: int, scale: float = 1e-2) -> None:
    """Give every lora_up a seeded draw (they start at zero, which leaves the
    `lora_down` gradients zero and untested)."""
    from leco_tpu_torch.lora import lora_parameters

    gen = torch.Generator(device=next(unet.parameters()).device).manual_seed(seed + 1)
    for name, p in lora_parameters(unet).items():
        if name.endswith("lora_up"):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * scale)


def step_once(unet, spec, case: dict, device, lr: float) -> dict:
    """One step of `make_train_step` on the case's pack and latents ->
    loss, LoRA gradients and weights after the step, flash calls."""
    from leco_tpu_torch.ops.schedulers import NoiseScheduler
    from leco_tpu_torch.train import trainer
    from leco_tpu_torch.train.optim import get_optimizer

    bundle = trainer.ModelBundle(unet=unet, scheduler=NoiseScheduler("ddim"), spec=spec,
                                 device=device)
    params = bundle.lora_params
    step = trainer.make_train_step(bundle, get_optimizer("adamw", list(params.values()), lr),
                                   case["max_steps"])
    pack = {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(device)) for k, v in case["pack"].items()}
    with counting_kernels() as calls:
        loss = step(pack, case["guidance_scale"], case["erase_sign"], case["timesteps_to"],
                    height=case["res"], width=case["res"], latents=case["latents"].to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
    return {"loss": float(loss),
            "grads": {k: p.grad.detach().float().cpu() for k, p in params.items()},
            "lora": {k: p.detach().float().cpu() for k, p in params.items()},
            "calls": dict(calls)}


def run_steps(job: dict) -> dict:
    from leco_tpu_torch.parallel.context import ParallelContext
    from leco_tpu_torch.parallel.mesh import ProcessMesh
    from leco_tpu_torch.parallel.sharding import shard_unet

    device = torch.device(job.get("device", "cpu"))
    cases = job["cases"]
    out = {}
    for name, entry in job["steps"].items():
        case = cases[entry["case"]]
        unet, spec = build_unet(case, device)
        unet.checkpoint_unet = entry.get("checkpoint_unet", False)
        mesh = ProcessMesh(*entry["mesh"], device)
        plan = shard_unet(unet, mesh)
        unet.set_parallel(ParallelContext(mesh, len(unet.cfg.block_out_channels)))
        gates = open_gates() if entry.get("open_gates") else contextlib.nullcontext()
        with controls(entry.get("control")), _environ(entry.get("knobs", {})), gates:
            out[name] = step_once(unet, spec, case, device, job.get("lr", 1e-4))
        out[name]["tp_layers"] = len(plan)
        out[name]["coords"] = dict(mesh.coords)
        del unet
        if device.type == "cuda":
            out[name]["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return out


# ---------------------------------------------------------------------------
# "seed": the shared seed and the run's draws
# ---------------------------------------------------------------------------


def run_seed(job: dict) -> dict:
    from leco_tpu_torch.parallel.distributed import shared_seed
    from leco_tpu_torch.train import trainer

    seed = shared_seed(None)
    rng, generator = trainer.run_generators(None, torch.device("cpu"))
    return {"seed": seed, "schedule": [int(rng.integers(1, 50)) for _ in range(8)],
            "latents": torch.randn((1, 4, 8, 8), generator=generator)}


# ---------------------------------------------------------------------------
# "resume": a sharded run interrupted and resumed
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def run_resume(job: dict) -> dict:
    """`train()` on the tiny bundle over an sp mesh of the whole world, 4
    iterations uninterrupted and again stopped in iteration 2 (before its
    snapshot) then resumed. Each rank saves under a directory of its own, as
    ranks on nodes that share no disk do, so only rank 0 finds the snapshot
    -> {"whole", "resumed": {"losses", "lora"}, "snapshot_seen"}."""
    from leco_tpu_torch.config import RootConfig
    from leco_tpu_torch.parallel.context import ParallelContext
    from leco_tpu_torch.parallel.mesh import SP_AXIS, ProcessMesh
    from leco_tpu_torch.parallel.sharding import shard_unet
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.testing import make_random_bundle
    from leco_tpu_torch.train import checkpoint as ckpt
    from leco_tpu_torch.train import trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    root = Path(job["workdir"])
    prompt = PromptSettings.from_dict({"target": "van gogh", "resolution": 64})

    def train(name: str, resume: bool = False, stop_at=None) -> dict:
        bundle = make_random_bundle(attn_backend="flash")
        mesh = ProcessMesh(SP_AXIS, world, bundle.device)
        shard_unet(bundle.unet, mesh)
        bundle.unet.set_parallel(ParallelContext(mesh, len(bundle.unet.cfg.block_out_channels)))
        config = RootConfig.from_dict({
            "prompts_file": "unused.yaml",
            "pretrained_model": {"name_or_path": "random://tiny"},
            "train": {"iterations": 4, "max_denoising_steps": 3, "lr": 1e-3, "seed": 0,
                      "precision": "float32", "optimizer": "lion", "lr_scheduler": "cosine",
                      "noise_scheduler": "ddpm", "save_state": True, "resume": resume},
            "save": {"name": "tiny", "path": str(root / name / f"rank{rank}"),
                     "per_steps": 1, "precision": "float32"},
        })

        def hook(i, loss):
            if i == stop_at:
                raise _Stop

        return trainer.train(config, [prompt], bundle, on_step=hook)

    whole = train("whole")
    try:
        train("cut", stop_at=2)
        raise AssertionError("the cut run was not stopped")
    except _Stop:
        pass
    seen = ckpt.latest_step(root / "cut" / f"rank{rank}" / "state")
    resumed = train("cut", resume=True)
    return {"whole": {"losses": whole["losses"], "lora": whole["lora"]},
            "resumed": {"losses": resumed["losses"], "lora": resumed["lora"]},
            "snapshot_seen": seen}


JOBS = {"ops": run_ops, "knob_ops": run_knob_ops, "steps": run_steps, "seed": run_seed,
        "resume": run_resume}
