"""The fused knobs' kernel routes against their knob-off routes, on the card,
at the shapes where the JAX package's knob gates send the call to XLA.

    python -m leco_tpu_torch.kernels.time_gates

The JAX gates refuse these shapes for TPU reasons (a VMEM budget, a table
tuned on a v5e), so the port decides them by its own card's numbers. Each
route makes the calls the UNet makes with its knob on or off (bf16,
forward), so that the port's own gates do not pick them:

  * GroupNorm (`LECO_TPU_FUSED_GN=1`): `fused_group_norm` (the kernel)
    against `F.group_norm` in fp32 (+ SiLU), both rotated over enough input
    copies to exceed twice the L2 (the row is bound by bytes);
  * GEGLU (`LECO_GEGLU=fused`): `geglu_fused` against `geglu_reference`
    (`F.linear`, then the fp32 A&S gelu and the product);
  * packed attention (`LECO_FLASH_PACKED=1`): `flash_attention_packed`
    against the 3-d kernels with their head transposes (the output made
    contiguous, as the projection after it needs);
  * GroupNorm-SiLU-conv (`LECO_RESNET_FUSED=1`): a resnet's first half
    (`models.unet.GroupNorm` with SiLU, then `lora.LoRAConv2d`) as
    `ResnetBlock2D` runs it: the GroupNorm collapsed to an affine and the
    gnconv3x3 kernel, against the route a conv the gate refuses takes with
    the rest of the fused configuration on (`FUSED_KNOBS`: the GroupNorm
    kernel, then conv3x3), and, for context, with every knob off
    (GroupNorm, SiLU, cuDNN's conv).

Each route is timed `REPEATS` times in turns (knob, off, off, knob, ...) by
`timing.device_ms`, in each of `ROUNDS` rounds. `decide` sends a shape to
the knob-off route only where, in every round, the kernel route is slower
than the route a refused shape takes in the fused configuration by more
than `GATE_MARGIN` of that route's time, and keeps the kernel everywhere
else: near-ties, which flip between calls, stay on the kernel. One JSON
line per shape and round; then the shapes decided "off", and whether each
knob's gate in the code (`supports`, `supports_packed`) agrees.

Then the end-to-end check of the gnconv gate: one SD1.5 train step (512 px,
t_to 10, lierla) and one SDXL UNet forward (1024 px, B 2) with every knob
on, device time per call, with the gate as it is (`gn_conv.MAX_FUSED_SIDE`)
and with it admitting every size (the gate before the H100's timing), in
turns. Last, the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

REPEATS = 3
SAMPLES = 3  # profiler samples in each `timing.device_ms`
ROUNDS = 2
GATE_MARGIN = 0.10
# the JAX package's fused-kernel configuration (as chip_smoke sets it)
FUSED_KNOBS = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1",
               "LECO_TPU_FUSED_GN": "1", "LECO_GEGLU": "fused"}
# (B, C, H, W, eps, silu): SDXL's conv_norm_out (and the level-0 resnet
# norms) at 1024 px, SDXL's level-1 transformer norms, SD2.1's level-0
# transformer norms at 768 px; B 2, the inner loop's CFG batch
GN_SHAPES = [(2, 320, 128, 128, 1e-5, True), (2, 640, 64, 64, 1e-6, False),
             (2, 320, 96, 96, 1e-6, False)]
# (M, K, N): K 1280 at SDXL's level 2 at 1024 px and SD1.5's level 2 and
# mid block at 512 px, B 2 (M = B x tokens)
GEGLU_SHAPES = [(2 * 1024, 1280, 5120), (2 * 256, 1280, 5120), (2 * 64, 1280, 5120)]
# (B, N, C, heads): SDXL's level 1 at 1024 px, SD2.1's level 0 at 768 px
PACKED_SHAPES = [(2, 4096, 640, 10), (2, 9216, 320, 5)]
# the resnet convs above 16 x 16 (the JAX gate sends every one to XLA) of
# these (model, resolution) runs of the repo's recipes, at B 2
GNCONV_RUNS = (("sd15", 512), ("sd21", 512), ("sd21", 640), ("sd21", 768), ("sdxl", 1024))
GNCONV_BATCH = 2


def resnet_convs(config, height: int, width: int) -> list[tuple[int, int, int, int, bool]]:
    """(Cin, H, W, Cout, needs_dx) of every resnet 3x3 conv of one UNet
    forward at height x width px, in order; `needs_dx`: its input needs a
    gradient when only the text embedding (or a LoRA of the transformers)
    does, i.e. a transformer ran before it. Traced on the meta device."""
    import torch

    from leco_tpu_torch.models.unet import ResnetBlock2D, UNet2DConditionModel

    with torch.device("meta"):
        unet = UNet2DConditionModel(config)
    unet.requires_grad_(False)
    out = []

    def hook(conv, args):
        x = args[0]
        out.append((x.shape[1], x.shape[2], x.shape[3], conv.out_channels, x.requires_grad))

    for block in unet.modules():
        if isinstance(block, ResnetBlock2D):
            block.conv1.register_forward_pre_hook(hook)
            block.conv2.register_forward_pre_hook(hook)
    with torch.device("meta"):
        ctx = torch.zeros(1, 77, config.cross_attention_dim, requires_grad=True)
        added = None
        if unet.is_xl:
            pooled = config.projection_class_embeddings_input_dim - 6 * (
                config.addition_time_embed_dim)
            added = {"text_embeds": torch.zeros(1, pooled), "time_ids": torch.zeros(1, 6)}
        unet(torch.zeros(1, config.in_channels, height // 8, width // 8), 0.0, ctx, added)
    return out


def gnconv_shapes() -> list[tuple[int, int, int, int, int]]:
    """(B, Cin, H, W, Cout) of GNCONV_RUNS' resnet convs above 16 x 16."""
    from leco_tpu_torch.models.unet import sd15_config, sd21_config, sdxl_config

    configs = {"sd15": sd15_config(), "sd21": sd21_config(), "sdxl": sdxl_config()}
    shapes = []
    for model, res in GNCONV_RUNS:
        for cin, h, w, cout, _ in resnet_convs(configs[model], res, res):
            shape = (GNCONV_BATCH, cin, h, w, cout)
            if h > 16 and shape not in shapes:
                shapes.append(shape)
    return shapes


def decide(knob_ms: list[float], off_ms: list[float]) -> str:
    """"off" where the kernel route's median is above the knob-off route's
    by more than GATE_MARGIN of it, else "kernel"."""
    slower = statistics.median(knob_ms) > (1 + GATE_MARGIN) * statistics.median(off_ms)
    return "off" if slower else "kernel"


def in_turns(routes, timing, **kw) -> list[list[float]]:
    """REPEATS device times of each route (`timing.device_ms(route, **kw)`),
    taken in turns, the order reversed every other repeat."""
    times = [[] for _ in routes]
    for r in range(REPEATS):
        order = list(enumerate(routes))
        for i, fn in (order if r % 2 == 0 else order[::-1]):
            times[i].append(timing.device_ms(fn, **{"repeats": SAMPLES, **kw}))
    return times


def under(env: dict, fn):
    """`fn` made to run with each variable of `env` set (None: unset)."""
    def apply(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def call():
        saved = {k: os.environ.get(k) for k in env}
        apply(env)
        try:
            return fn()
        finally:
            apply(saved)
    return call


def report(kind: str, shape, rnd: int, names, times) -> str:
    """Print one shape's times; decide on the first two routes (a third is
    context)."""
    decision = decide(times[0], times[1])
    print(json.dumps({
        "knob": kind, "shape": list(shape), "round": rnd,
        **{f"{n}_ms": t for n, t in zip(names, times)},
        **{f"{n}_median_ms": statistics.median(t) for n, t in zip(names, times)},
        "decision": decision}), flush=True)
    return decision


def time_routes(device, gen, rnd: int, timing) -> dict:
    """One round over every knob's refused shapes -> {(knob, shape): decision}."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from leco_tpu_torch import lora
    from leco_tpu_torch.models.unet import GroupNorm
    from leco_tpu_torch.ops import flash_attention as fa
    from leco_tpu_torch.ops import geglu
    from leco_tpu_torch.ops import group_norm as gn

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def norm_off(x, weight, bias, eps, silu):
        """`models.unet.GroupNorm` with LECO_TPU_FUSED_GN unset."""
        y = F.group_norm(x.float(), 32, weight, bias, eps)
        return (F.silu(y) if silu else y).to(x.dtype)

    decisions = {}
    for b, c, h, w, eps, silu in GN_SHAPES:
        weight, bias = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(
            c, scale=0.1, dtype=torch.float32)
        copies = [randn(b, c, h, w, scale=2.0)
                  for _ in range(timing.rotation_count(b * c * h * w * 2))]
        shape = (b, c, h, w, eps, silu)
        decisions["group_norm", shape] = report("group_norm", shape, rnd, ("kernel", "off"),
                                                in_turns((
            [lambda t=t: gn.fused_group_norm(t, weight, bias, 32, eps, silu) for t in copies],
            [lambda t=t: norm_off(t, weight, bias, eps, silu) for t in copies]), timing))

    for m, k, n in GEGLU_SHAPES:
        x, wt = randn(m, k), randn(2 * n, k, scale=k**-0.5)
        bias = randn(2 * n, dtype=torch.float32)
        decisions["geglu", (m, k, n)] = report("geglu", (m, k, n), rnd, ("kernel", "off"),
                                               in_turns((
            lambda: geglu.geglu_fused(x, wt, bias),
            lambda: geglu.geglu_reference(x, wt, bias)), timing))

    for b, n, c, heads in PACKED_SHAPES:
        q, k_, v = randn(b, n, c), randn(b, n, c), randn(b, n, c)
        scale = (c // heads) ** -0.5

        def three_d(q=q, k_=k_, v=v, heads=heads, scale=scale):
            """`ops.attention.multi_head_attention`'s 3-d route."""
            q3, k3, v3 = (rearrange(t, "b n (h d) -> (b h) n d", h=heads).contiguous()
                          for t in (q, k_, v))
            return rearrange(fa.flash_attention_3d(q3, k3, v3, scale),
                             "(b h) n d -> b n (h d)", h=heads).contiguous()

        shape = (b, n, c, heads)
        decisions["packed", shape] = report("packed", shape, rnd, ("kernel", "off"), in_turns((
            lambda: fa.flash_attention_packed(q, k_, v, heads, scale), three_d), timing))

    knobs_off = {k: None for k in FUSED_KNOBS}
    for b, cin, h, w, cout in gnconv_shapes():
        norm = GroupNorm(32, cin, 1e-5, silu=True).to(device, torch.bfloat16)
        conv = lora.LoRAConv2d(cin, cout, 3, padding=1).to(device, torch.bfloat16)
        with torch.no_grad():
            norm.weight.copy_(1 + randn(cin, scale=0.1))
            norm.bias.copy_(randn(cin, scale=0.1))
            conv.weight.copy_(randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5))
            conv.bias.copy_(randn(cout))
        x = randn(b, cin, h, w, scale=2.0)
        shape = (b, cin, h, w, cout)
        decisions["gnconv3x3", shape] = report(
            "gnconv3x3", shape, rnd, ("kernel", "fused_config", "knobs_off"), in_turns((
                # ResnetBlock2D's fused branch, then its other branch
                lambda x=x, norm=norm, conv=conv: conv(x, affine=norm(x, affine_only=True)),
                under(FUSED_KNOBS, lambda x=x, norm=norm, conv=conv: conv(norm(x))),
                under(knobs_off, lambda x=x, norm=norm, conv=conv: conv(norm(x)))), timing))
    return decisions


def time_end_to_end(device, sides: dict, timing) -> None:
    """Device time per call of one SD1.5 train step (512 px, t_to 10,
    lierla) and one SDXL UNet forward (1024 px, B 2) with every knob on,
    with each gnconv gate of `sides` (name -> `gn_conv.MAX_FUSED_SIDE`), in
    turns."""
    import torch

    from leco_tpu_torch import testing
    from leco_tpu_torch.ops import gn_conv
    from leco_tpu_torch.prompts import PromptSettings
    from leco_tpu_torch.train import diffusion, trainer
    from leco_tpu_torch.train.optim import get_optimizer

    def with_side(side, fn):
        def call():
            saved = gn_conv.MAX_FUSED_SIDE
            gn_conv.MAX_FUSED_SIDE = side
            try:
                return fn()
            finally:
                gn_conv.MAX_FUSED_SIDE = saved
        return under(FUSED_KNOBS, call)

    def compare(what, fn, **kw):
        times = in_turns([with_side(side, fn) for side in sides.values()], timing, **kw)
        print(json.dumps({"end_to_end": what, **{
            f"{name}_ms": t for name, t in zip(sides, times)}, **{
            f"{name}_median_ms": statistics.median(t) for name, t in zip(sides, times)}}),
              flush=True)

    torch.set_grad_enabled(True)
    bundle = testing.make_sd15_bundle(dtype=torch.bfloat16, seed=0, device=device)
    settings = PromptSettings.from_dict({"target": "van gogh", "resolution": 512})
    pack = trainer.build_pack(trainer.encode_prompt_pairs([settings], bundle.encode_fn)[0])
    step = trainer.make_train_step(
        bundle, get_optimizer("adamw", list(bundle.lora_params.values()), 1e-4), 50)
    gen = torch.Generator(device).manual_seed(0)
    compare("sd15 train step, 512 px, t_to 10",
            lambda: step(pack, 1.0, 1.0, 10, height=512, width=512, generator=gen),
            calls=1, repeats=3, warmup=1)
    del bundle, pack, step
    torch.cuda.empty_cache()

    torch.set_grad_enabled(False)
    unet = testing.make_sdxl_bundle(dtype=torch.bfloat16, seed=0, device=device).unet
    x = torch.randn((2, 4, 128, 128), generator=gen, device=device)
    ctx = torch.randn((2, 77, unet.cfg.cross_attention_dim), generator=gen, device=device)
    added = {"text_embeds": torch.randn((2, testing.xl_pooled_dim(unet.cfg)),
                                        generator=gen, device=device),
             "time_ids": torch.from_numpy(diffusion.get_add_time_ids(1024, 1024)).to(
                 device).repeat(2, 1)}
    compare("sdxl forward, 1024 px, B 2", lambda: unet(x, 501.0, ctx, added),
            calls=2, repeats=3, warmup=1)


def gates_agree(decisions: dict) -> dict:
    """knob -> whether its gate in the code keeps the kernel at exactly the
    shapes decided "kernel"."""
    import torch

    from leco_tpu_torch.ops import flash_attention as fa
    from leco_tpu_torch.ops import geglu, gn_conv
    from leco_tpu_torch.ops import group_norm as gn

    cuda = torch.device("cuda")
    gate = {
        "group_norm": lambda shape: gn.supports(torch.bfloat16, cuda),
        "geglu": lambda shape: geglu.supports(torch.bfloat16, cuda),
        "packed": lambda shape: fa.supports_packed(shape[1], shape[1], shape[2], shape[3]),
        "gnconv3x3": lambda shape: gn_conv.supports(shape[:4], shape[4], torch.bfloat16, cuda),
    }
    agree = {}
    for (kind, shape), decision in decisions.items():
        agree[kind] = agree.get(kind, True) and gate[kind](shape) is (decision == "kernel")
    return agree


def main() -> int:
    import torch

    from leco_tpu_torch.kernels import timing
    from leco_tpu_torch.kernels.build import library
    from leco_tpu_torch.ops import gn_conv

    if not torch.cuda.is_available():
        raise SystemExit("time_gates: CUDA is not available; this script needs one GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    library()
    gen = torch.Generator(device).manual_seed(0)
    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=device)
    for _ in range(100):  # the clocks up before the first timing
        a @ a
    torch.cuda.synchronize()
    del a

    torch.set_grad_enabled(False)
    rounds = [time_routes(device, gen, rnd, timing) for rnd in range(ROUNDS)]
    decisions = {key: "off" if all(r[key] == "off" for r in rounds) else "kernel"
                 for key in rounds[0]}
    print(json.dumps({"off_in_every_round": [key for key, d in decisions.items() if d == "off"],
                      "gates_agree": gates_agree(decisions)}), flush=True)
    time_end_to_end(device, {"gate": gn_conv.MAX_FUSED_SIDE, "every_size": 1 << 30}, timing)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
