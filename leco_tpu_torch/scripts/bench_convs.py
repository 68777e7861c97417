"""Microbenchmark the hot SD1.5 conv shapes on the card: `F.conv2d` in the
UNet's NCHW layout, with a channels_last weight only, and in channels_last,
against the im2col-GEMM form, with achieved TFLOP/s and MFU.

    python -m leco_tpu_torch.scripts.bench_convs [--matmul] [--iters 64] \
        [--device cuda|cpu]

Counterpart of `scripts/bench_convs.py`. The same 14 cases in bf16, each
chained through its carry for `--iters` calls (`benchkit.chained_times`):
the output sliced or zero-padded back to the input's channels and scaled
by 0.999 rounded to the carry's dtype (the JAX script's
`jnp.bfloat16(0.999)`, which is 1.0 in bf16); a stride-2 output tiled back
to the input's size. The JAX script's NHWC conv is `channels_last` here
(activations and weight); NCHW contiguous, both, is what the port's UNet
hands cuDNN (`models/unet.py`). The third layout, `nchw_weight_cl`, keeps
the activations NCHW and the weight channels_last (converted once, outside
the timed calls, as the channels_last weight is): PyTorch then runs the
conv channels_last, converting x and the carry's output each call, so the
three columns split the NCHW conv's conversions into the weight's and the
activations'.
The im2col form pads, takes the 9 shifted slices, concatenates them on the
channels and runs one `torch.matmul` (channels last, as the JAX script's).
`--matmul` times the script's 14 GEMM shapes instead.

Each time is given twice: `ms`, CUDA events around the chained loop (the
host's launch cost of every call counts, which XLA's `lax.scan` did not
pay), and `device_ms`, the device's own time per call from torch.profiler.
MFU is against `kernels/roofline.BF16_TENSOR_FLOPS` (the H100's dense bf16
peak); it is a device number, so a CPU run gives none. cuDNN's and TF32's
settings stay as the process has them and are recorded. `--device`
defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import torch
import torch.nn.functional as F

WEIGHT_SCALE = 0.02
CARRY_SCALE = 0.999
ITERS = 64

CASES = [
    # (batch, spatial, cin, cout, stride)  — SD1.5 @512px hot convs
    (2, 64, 320, 320, 1),
    (2, 64, 640, 320, 1),
    (2, 64, 960, 320, 1),
    (2, 64, 320, 320, 2),   # downsample
    (2, 32, 640, 640, 1),
    (2, 32, 960, 640, 1),
    (2, 32, 1280, 640, 1),
    (2, 32, 640, 640, 2),
    (2, 16, 1280, 1280, 1),
    (2, 16, 1920, 1280, 1),
    (2, 16, 2560, 1280, 1),
    (2, 16, 1280, 1280, 2),
    (2, 8, 1280, 1280, 1),
    (2, 8, 2560, 1280, 1),
]

# (M, K, N) of the JAX script's --matmul table
GEMM_CASES = [
    (8192, 2880, 320), (8192, 320, 320), (8192, 5760, 320),
    (8192, 8640, 320), (2048, 5760, 640), (2048, 11520, 640),
    (512, 11520, 1280), (512, 23040, 1280), (128, 23040, 1280),
    (8192, 2880, 384), (8192, 2880, 512), (8192, 2880, 128),
    (8192, 2880, 2880), (8192, 320, 2560),
]

# (activations' memory format, weight's memory format)
LAYOUTS = {"nchw": (torch.contiguous_format, torch.contiguous_format),
           "nchw_weight_cl": (torch.contiguous_format, torch.channels_last),
           "channels_last": (torch.channels_last, torch.channels_last)}


def carry_scale(dtype: torch.dtype, device) -> torch.Tensor:
    """0.999 rounded to the carry's dtype, as the JAX scripts multiply."""
    return torch.tensor(CARRY_SCALE, dtype=dtype, device=device)


def renorm(y: torch.Tensor, cin: int, scale: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Back to `cin` channels on `dim`: the first `cin` scaled, or zero
    rows appended (unscaled), as the JAX scripts keep the carry's shape."""
    cout = y.shape[dim]
    if cout >= cin:
        return y.narrow(dim, 0, cin) * scale
    pad = [0, 0] * (y.ndim - 1 - dim % y.ndim) + [0, cin - cout]
    return F.pad(y, pad)


def conv_carry(weight: torch.Tensor, stride: int, scale: torch.Tensor,
               memory_format=torch.contiguous_format) -> Callable:
    """The JAX script's `conv_case` body on an NCHW tensor in
    `memory_format`: the 3x3 pad-1 conv, a stride-2 output tiled 2 x 2,
    cropped to the input's size, `renorm`, back in `memory_format`."""
    cin = weight.shape[1]

    def conv(c: torch.Tensor) -> torch.Tensor:
        h, w = c.shape[2:]
        y = F.conv2d(c, weight, None, stride, 1)
        if stride == 2:
            y = y.repeat(1, 1, 2, 2)
        return renorm(y[:, :, :h, :w], cin, scale).contiguous(memory_format=memory_format)

    return conv


def im2col(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The 3x3 pad-1 conv of NHWC `x` as one GEMM: the 9 shifted slices of
    the padded input concatenated on the channels (tap-major, as the JAX
    script's), times `k` (9 Cin, Cout) -> NHWC."""
    b, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)]
    patches = torch.cat(cols, dim=-1).reshape(b * h * w, 9 * cin)
    return torch.matmul(patches, k).reshape(b, h, w, k.shape[1])


def im2col_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the (9 Cin, Cout) matrix whose `im2col`
    product is the conv."""
    return weight.permute(2, 3, 1, 0).reshape(9 * weight.shape[1], weight.shape[0])


def im2col_carry(k: torch.Tensor, scale: torch.Tensor) -> Callable:
    """The JAX script's `im2col_case` body: NHWC in, NHWC out."""
    cin = k.shape[0] // 9
    return lambda c: renorm(im2col(c, k), cin, scale, dim=-1)


def matmul_carry(w: torch.Tensor, scale: torch.Tensor) -> Callable:
    """The JAX script's `matmul_case` body: (M, K) @ (K, N), back to K."""
    return lambda c: renorm(c @ w, w.shape[0], scale, dim=-1)


def seeded_randn(shape, seed: int, dtype, device, scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2) draws in fp32 from a generator seeded `seed` on
    `device`, cast to `dtype`."""
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def conv_flops(b: int, h: int, cin: int, cout: int, stride: int = 1) -> int:
    ho = h // stride
    return 2 * b * ho * ho * 9 * cin * cout


def timed(fn: Callable, x: torch.Tensor, flops: int, iters: int, repeats: int = 1) -> dict:
    """`benchkit.chained_times` of `fn` from `x` -> ms and device ms per
    call, each with its MFU (None off the card)."""
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS
    from leco_tpu_torch.utils import benchkit

    t = benchkit.chained_times(fn, x, iters, repeats)
    on_card = x.is_cuda
    dev = t["device_ms"]
    return {"ms": t["s"] * 1e3, "device_ms": dev,
            "mfu": flops / t["s"] / BF16_TENSOR_FLOPS if on_card else None,
            "device_mfu": flops / (dev / 1e3) / BF16_TENSOR_FLOPS if on_card else None}


def conv_row(b: int, h: int, cin: int, cout: int, stride: int, device, iters: int,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """One case: the conv in every layout of LAYOUTS and, at stride 1, the
    im2col form; the same x (seed 0) and weights (seed 1, x 0.02) for all."""
    x = seeded_randn((b, cin, h, h), 0, dtype, device)
    weight = seeded_randn((cout, cin, 3, 3), 1, dtype, device, WEIGHT_SCALE)
    scale = carry_scale(dtype, device)
    flops = conv_flops(b, h, cin, cout, stride)
    row = {"case": f"b{b} {h}x{h} {cin}->{cout} s{stride}", "shape": [b, h, cin, cout, stride],
           "flops": flops}
    for name, (act, wfmt) in LAYOUTS.items():
        row[name] = timed(conv_carry(weight.contiguous(memory_format=wfmt), stride, scale, act),
                          x.contiguous(memory_format=act), flops, iters)
    row["im2col"] = (timed(im2col_carry(im2col_weight(weight), scale),
                           x.permute(0, 2, 3, 1).contiguous(), flops, iters)
                     if stride == 1 else None)
    return row


def matmul_row(m: int, kdim: int, n: int, device, iters: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    x = seeded_randn((m, kdim), 0, dtype, device)
    w = seeded_randn((kdim, n), 1, dtype, device, WEIGHT_SCALE)
    flops = 2 * m * kdim * n
    return {"case": f"{m}x{kdim}x{n}", "shape": [m, kdim, n], "flops": flops,
            "gemm": timed(matmul_carry(w, carry_scale(dtype, device)), x, flops, iters)}


def pct(v: Optional[float]) -> str:
    return "-" if v is None else f"{100 * v:.1f}%"


def fmt(v: Optional[float], spec: str = ".4f") -> str:
    return "-" if v is None else format(v, spec)


def main(argv=None, cases=None) -> dict:
    """Time every case (or `cases`: conv or GEMM tuples as in CASES /
    GEMM_CASES), print the table and one JSON record, and return it."""
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--matmul", action="store_true", help="the GEMM shapes instead")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to time on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    rows = []
    with torch.no_grad():
        if args.matmul:
            print(f"{'GEMM case':24s} {'ms':>9s} {'dev ms':>9s} {'MFU':>7s} {'dev MFU':>7s}")
            for m, kdim, n in cases or GEMM_CASES:
                row = matmul_row(m, kdim, n, device, args.iters)
                g = row["gemm"]
                print(f"{row['case']:24s} {g['ms']:9.4f} {fmt(g['device_ms']):>9s} "
                      f"{pct(g['mfu']):>7s} {pct(g['device_mfu']):>7s}", flush=True)
                rows.append(row)
        else:
            cols = [f"{a} {b}" for a in ("nchw", "w_cl", "cl", "i2c")
                    for b in ("ms", "dev", "MFU", "dMFU")]
            print(f"{'case':26s} " + " ".join(f"{c:>9s}" for c in cols))
            for b, h, cin, cout, stride in cases or CASES:
                row = conv_row(b, h, cin, cout, stride, device, args.iters)
                cells = []
                for key in (*LAYOUTS, "im2col"):
                    t = row[key] or {}
                    cells += [fmt(t.get("ms")), fmt(t.get("device_ms")), pct(t.get("mfu")),
                              pct(t.get("device_mfu"))]
                print(f"{row['case']:26s} " + " ".join(f"{c:>9s}" for c in cells), flush=True)
                rows.append(row)
                if on_card:
                    torch.cuda.empty_cache()
    record = {
        "script": "bench_convs", "mode": "matmul" if args.matmul else "conv",
        "dtype": "bfloat16", "iters": args.iters, "platform": benchkit.platform(device),
        "device": benchkit.device_record() if on_card else None,
        "backend_flags": benchkit.backend_flags(), "peak_flops": BF16_TENSOR_FLOPS,
        "rows": rows,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
