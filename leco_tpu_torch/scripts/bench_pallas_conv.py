"""The port's conv kernel (kernel 5, `leco_conv3x3`) against `F.conv2d` at
the hot SD1.5 resnet conv shapes on the card.

    python -m leco_tpu_torch.scripts.bench_pallas_conv [--iters 64] [--device cuda|cpu]

Counterpart of `scripts/bench_pallas_conv.py`. The same 11 cases in bf16
with fp32 zero bias, chained through the carry (`benchkit.chained_times`,
the best of REPEATS passes), after a calibration of the harness's fixed
cost on a trivial `x * 0.999` at (2, 320, 64, 64): each MFU is given raw
and with that floor taken off the time. The "xla" column is `F.conv2d` in
the port's NCHW layout plus the bias, the "kernel" column is
`ops/conv.conv3x3` as the UNet calls it under `LECO_CONV_BACKEND=gemm`
(`lora.LoRAConv2d`), so the per-call weight repack (`leco_conv3x3_pack`)
is in its time; the repack's own device time per call is given beside it,
with its share of the kernel's. Each row also carries the conv's roofline
bound (`kernels/roofline.py`) and the check of the kernel's output: one
unchained call of each column on the case's x, the kernel within RTOL x
max|ref| of the xla column, and a control that must fail that limit (the
kernel on the weight with its 3x3 taps flipped); the script raises when
either is off, so that no time of a wrong kernel is printed.

Every time is given as `ms` (CUDA events around the chained loop, the
host's launch cost included) and `device_ms` (torch.profiler, the median
of REPEATS samples). MFU is against `kernels/roofline.BF16_TENSOR_FLOPS`;
a CPU run (where `conv3x3` is its plain version) gives none. `--device`
defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from leco_tpu_torch.scripts.bench_convs import (
    ITERS,
    WEIGHT_SCALE,
    carry_scale,
    conv_flops,
    fmt,
    pct,
    renorm,
    seeded_randn,
    timed,
)

REPEATS = 3  # the JAX script's best of 3
RTOL = 1e-2  # the kernel's limit against the xla column, relative to max|ref|
FLOOR_SHAPE = (2, 320, 64, 64)  # (B, C, H, W) of the calibration's x * 0.999

CASES = [
    (2, 64, 320, 320),
    (2, 64, 640, 320),
    (2, 64, 960, 320),
    (2, 32, 640, 640),
    (2, 32, 960, 640),
    (2, 32, 1280, 640),
    (2, 16, 1280, 1280),
    (2, 16, 1920, 1280),
    (2, 16, 2560, 1280),
    (2, 8, 1280, 1280),
    (2, 8, 2560, 1280),
]


def conv_call(c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, impl: str,
              counter: Optional[dict] = None) -> torch.Tensor:
    """One conv of the column `impl` ("xla": `F.conv2d` + bias in c's dtype;
    "kernel": `ops/conv.conv3x3`, weight repack included). `counter["n"]`
    counts the kernel's calls."""
    from leco_tpu_torch.ops import conv as conv_ops

    if impl == "kernel":
        if counter is not None:
            counter["n"] += 1
        return conv_ops.conv3x3(c, weight, bias)
    if impl == "xla":
        return F.conv2d(c, weight, None, 1, 1) + bias.to(c.dtype)[None, :, None, None]
    raise ValueError(f"unknown conv impl {impl!r}")


def conv_carry(weight: torch.Tensor, bias: torch.Tensor, impl: str, scale: torch.Tensor,
               counter: Optional[dict] = None) -> Callable:
    """The JAX script's `make_case` body: `conv_call`, then `renorm`."""
    cin = weight.shape[1]
    return lambda c: renorm(conv_call(c, weight, bias, impl, counter), cin, scale)


def output_check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 counter: Optional[dict] = None) -> dict:
    """One unchained call of each column on `x`: the kernel's max|diff| from
    the xla column, the limit RTOL x max|ref|, and the control's (the kernel
    on `weight` with its 3x3 taps flipped, which must fail the limit).
    Raises when the kernel is past the limit or the control is not."""
    ref = conv_call(x, weight, bias, "xla").float()
    limit = RTOL * ref.abs().max().item()
    err = (conv_call(x, weight, bias, "kernel", counter).float() - ref).abs().max().item()
    control = (conv_call(x, weight.flip(2, 3), bias, "kernel", counter).float()
               - ref).abs().max().item()
    if not err <= limit:
        raise RuntimeError(f"the conv kernel is {err} off F.conv2d, past {limit}")
    if not control > limit:
        raise RuntimeError(f"the flipped-tap control ({control}) passes the limit {limit}")
    return {"max_abs_err": err, "limit": limit, "control_max_abs_err": control}


def adjusted_mfu(flops: int, seconds: float, floor_s: float) -> float:
    """MFU with the harness's fixed cost a call taken off the time."""
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS

    return flops / max(seconds - floor_s, 1e-9) / BF16_TENSOR_FLOPS


def harness_floor(device, iters: int, dtype=torch.bfloat16) -> dict:
    """The chained-carry timer on `x * 0.999` at FLOOR_SHAPE."""
    from leco_tpu_torch.utils import benchkit

    x = seeded_randn(FLOOR_SHAPE, 0, dtype, device)
    scale = carry_scale(dtype, device)
    t = benchkit.chained_times(lambda c: c * scale, x, iters, REPEATS)
    return {"ms": t["s"] * 1e3, "device_ms": t["device_ms"]}


def case_row(b: int, h: int, cin: int, cout: int, device, iters: int, floor: dict,
             counter: dict, dtype=torch.bfloat16) -> dict:
    """One case: the output check, then both convs chained from the same x
    (seed 0) with the same weights (seed 1, x 0.02) and zero fp32 bias, the
    repack alone, the bound."""
    from leco_tpu_torch.kernels import roofline, timing
    from leco_tpu_torch.ops import conv as conv_ops

    x = seeded_randn((b, cin, h, h), 0, dtype, device)
    weight = seeded_randn((cout, cin, 3, 3), 1, dtype, device, WEIGHT_SCALE)
    bias = torch.zeros((cout,), dtype=torch.float32, device=device)
    scale = carry_scale(dtype, device)
    flops = conv_flops(b, h, cin, cout)
    on_card = x.is_cuda
    row = {"case": f"b{b} {h}x{h} {cin}->{cout}", "shape": [b, h, cin, cout], "flops": flops,
           **roofline.kernel_bound("conv3x3", (b, cin, h, h, cout)),
           "check": output_check(x, weight, bias, counter)}
    for impl in ("xla", "kernel"):
        fn = conv_carry(weight, bias, impl, scale, counter if impl == "kernel" else None)
        t = timed(fn, x, flops, iters, REPEATS)
        t["mfu_adjusted"] = (adjusted_mfu(flops, t["ms"] / 1e3, floor["ms"] / 1e3)
                             if on_card else None)
        row[impl] = t
    row["speedup"] = row["xla"]["ms"] / row["kernel"]["ms"]
    row["device_speedup"] = (row["xla"]["device_ms"] / row["kernel"]["device_ms"]
                             if on_card else None)
    repack = (timing.device_ms(lambda: conv_ops.pack_weight(weight), calls=iters,
                               repeats=REPEATS) if on_card else None)
    row["repack_device_ms"] = repack
    row["repack_share_of_kernel"] = repack / row["kernel"]["device_ms"] if on_card else None
    return row


def main(argv=None, cases=None) -> dict:
    """Calibrate, time every case (or `cases`, tuples as in CASES), print
    the table and one JSON record, and return it."""
    from leco_tpu_torch.kernels.roofline import BF16_TENSOR_FLOPS
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to time on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    counter = {"n": 0}
    rows = []
    with torch.no_grad():
        floor = harness_floor(device, args.iters)
        print(f"harness floor (trivial op): {floor['ms']:.4f} ms/call, device "
              f"{fmt(floor['device_ms'])} ms/call", flush=True)
        print(f"{'case':22s} {'xla ms':>8s} {'dev':>8s} {'mfu':>6s} {'adj':>6s} {'dmfu':>6s} "
              f"{'kern ms':>8s} {'dev':>8s} {'mfu':>6s} {'adj':>6s} {'dmfu':>6s} "
              f"{'speedup':>7s} {'dev':>6s} {'repack':>8s} {'bound':>8s} "
              f"{'err/limit':>9s} {'control':>7s}")
        for b, h, cin, cout in cases or CASES:
            row = case_row(b, h, cin, cout, device, args.iters, floor, counter)
            cells = []
            for impl in ("xla", "kernel"):
                t = row[impl]
                cells += [f"{t['ms']:8.4f}", f"{fmt(t['device_ms']):>8s}"]
                cells += [f"{pct(t[k]):>6s}" for k in ("mfu", "mfu_adjusted", "device_mfu")]
            print(f"{row['case']:22s} " + " ".join(cells)
                  + f" {row['speedup']:6.2f}x {fmt(row['device_speedup'], '.2f'):>5s}x"
                  + f" {fmt(row['repack_device_ms']):>8s} {row['bound_ms']:8.4f}"
                  + f" {row['check']['max_abs_err'] / row['check']['limit']:9.3f}"
                  + f" {row['check']['control_max_abs_err'] / row['check']['limit']:7.1f}",
                  flush=True)
            rows.append(row)
            if on_card:
                torch.cuda.empty_cache()
    record = {
        "script": "bench_pallas_conv", "dtype": "bfloat16", "iters": args.iters,
        "repeats": REPEATS, "rtol": RTOL, "platform": benchkit.platform(device),
        "device": benchkit.device_record() if on_card else None,
        "backend_flags": benchkit.backend_flags(), "peak_flops": BF16_TENSOR_FLOPS,
        "harness_floor": floor, "kernel_calls": counter["n"], "rows": rows,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
