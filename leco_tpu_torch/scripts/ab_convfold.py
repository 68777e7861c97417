"""A/B on the card: the batch-2 3x3 conv against its batch-1 "H-fold" form,
which stacks the two samples along H with a 2-row zero seam, runs one conv
of twice the rows and slices the seam's rows away.

    python -m leco_tpu_torch.scripts.ab_convfold [--xl] [--iters 64] \
        [--device cuda|cpu]

Counterpart of `scripts/ab_convfold.py`, with `F.conv2d` in the port's NCHW
layout (the fold concatenates along dim 2): the SD1.5 512 px resnet conv
shapes, or SDXL's at 1024 px under `--xl`, each side chained through the
carry (`benchkit.chained_times`; the fold and the slices are in the timed
call, so B pays for its bookkeeping), and the totals.

With pad 1 the seam's two zero rows are each sample's own zero border, so
the folded output's rows 0..H-1 and H+2..2H+1 are the two samples'
outputs. The JAX script pins that as `err == 0.0` in fp32. On the card
cuDNN may pick another algorithm for the (2, H) and (1, 2H + 2) shapes,
and runs fp32 convs in TF32 unless told not to, so the pin here turns TF32
off for itself, reports max|diff| and whether it is bitwise, and holds it
to PIN_RTOL x max|ref| beside a control that must fail that limit: the
fold without seam rows, whose windows cross from one sample into the
other. `--device` defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from leco_tpu_torch.scripts.bench_convs import (
    ITERS,
    WEIGHT_SCALE,
    carry_scale,
    renorm,
    seeded_randn,
)

SEAM = 2  # zero rows between the two samples: one border row for each
PIN_SHAPE = (16, 64, 64)  # (spatial, cin, cout) of the exactness pin, fp32
PIN_RTOL = 1e-5  # the pin's limit on the card, relative to max|ref|

SDXL_CASES = [
    # SDXL @1024px batch-2 resnet conv shapes (levels 128/64/32; no 8x8)
    (128, 320, 320),
    (128, 640, 320),
    (128, 960, 320),
    (64, 640, 640),
    (64, 960, 640),
    (64, 1280, 640),
    (32, 1280, 1280),
    (32, 1920, 1280),
    (32, 2560, 1280),
]

CASES = [
    # (spatial, cin, cout) — SD1.5 @512px batch-2 resnet conv shapes
    (64, 320, 320),
    (64, 640, 320),   # up-block concat-widened conv1
    (64, 960, 320),
    (32, 640, 640),
    (32, 960, 640),
    (32, 1280, 640),
    (16, 1280, 1280),
    (16, 1920, 1280),
    (16, 2560, 1280),
    (8, 1280, 1280),
    (8, 2560, 1280),
]


def fold(x: torch.Tensor, seam: int = SEAM) -> torch.Tensor:
    """(2, C, H, W) -> (1, C, 2H + seam, W): sample 0, `seam` zero rows,
    sample 1."""
    if x.shape[0] != 2:
        raise ValueError(f"the H-fold stacks 2 samples, not {x.shape[0]}")
    zeros = x.new_zeros((x.shape[1], seam, x.shape[3]))
    return torch.cat([x[0], zeros, x[1]], dim=1)[None]


def folded_conv(x: torch.Tensor, weight: torch.Tensor, seam: int = SEAM) -> torch.Tensor:
    """The 3x3 pad-1 conv of the 2 samples of `x` as one batch-1 conv of
    their fold, the seam's rows sliced away -> (2, Cout, H, W)."""
    h = x.shape[2]
    yf = F.conv2d(fold(x, seam), weight, None, 1, 1)[0]
    return torch.stack([yf[:, :h], yf[:, h + seam:]], dim=0)


def plain_carry(weight: torch.Tensor, scale: torch.Tensor):
    cin = weight.shape[1]
    return lambda c: renorm(F.conv2d(c, weight, None, 1, 1), cin, scale)


def folded_carry(weight: torch.Tensor, scale: torch.Tensor):
    cin = weight.shape[1]
    return lambda c: renorm(folded_conv(c, weight), cin, scale)


def exactness_pin(device) -> dict:
    """The fold against the plain conv at PIN_SHAPE in fp32 with TF32 off
    for both, and the seamless control; raises when the fold is past
    PIN_RTOL x max|ref| or the control is not."""
    h, cin, cout = PIN_SHAPE
    weight = seeded_randn((cout, cin, 3, 3), 1, torch.float32, device)
    x = seeded_randn((2, cin, h, h), 0, torch.float32, device)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = F.conv2d(x, weight, None, 1, 1)
        err = (folded_conv(x, weight) - ref).abs().max().item()
        control = (folded_conv(x, weight, seam=0) - ref).abs().max().item()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    limit = PIN_RTOL * ref.abs().max().item()
    if err > limit:
        raise RuntimeError(f"the H-fold is {err} off the plain conv, past {limit}")
    if control <= limit:
        raise RuntimeError(f"the fold without a seam ({control}) passes the limit {limit}")
    return {"shape": [2, cin, h, h, cout], "max_abs_diff": err, "bitwise": err == 0.0,
            "limit": limit, "control_max_abs_diff": control}


def case_times(h: int, cin: int, cout: int, device, iters: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Both sides chained from the same x (seed 0) with the same weights
    (seed 1, x 0.02): ms and device ms per call."""
    from leco_tpu_torch.utils import benchkit

    x = seeded_randn((2, cin, h, h), 0, dtype, device)
    weight = seeded_randn((cout, cin, 3, 3), 1, dtype, device, WEIGHT_SCALE)
    scale = carry_scale(dtype, device)
    out = {"case": f"(2,{cin},{h},{h})->{cout}", "shape": [h, cin, cout]}
    for side, carry in (("plain", plain_carry), ("folded", folded_carry)):
        t = benchkit.chained_times(carry(weight, scale), x, iters)
        out[side] = {"ms": t["s"] * 1e3, "device_ms": t["device_ms"]}
    return out


def main(argv=None, cases=None) -> dict:
    """The pin, then every case (or `cases`: (spatial, cin, cout) tuples)
    with the totals; prints the table and one JSON record, returns it."""
    from leco_tpu_torch.train_lora import resolve_device
    from leco_tpu_torch.utils import benchkit

    ap = argparse.ArgumentParser()
    ap.add_argument("--xl", action="store_true", help="SDXL's 1024 px shapes")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to time on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cases = cases or (SDXL_CASES if args.xl else CASES)
    print(f"platform={benchkit.platform(device)} device={device} "
          f"cases={'xl' if args.xl else 'sd'}", flush=True)

    with torch.no_grad():
        pin = exactness_pin(device)
        print(f"fold exactness max|diff| = {pin['max_abs_diff']:.3e} (limit {pin['limit']:.3e}, "
              f"bitwise {pin['bitwise']}); without the seam {pin['control_max_abs_diff']:.3e}",
              flush=True)
        rows = []
        totals = {"plain": {"ms": 0.0, "device_ms": 0.0 if on_card else None},
                  "folded": {"ms": 0.0, "device_ms": 0.0 if on_card else None}}
        print(f"{'shape':>24} {'plain ms':>9} {'dev':>9} {'folded ms':>10} {'dev':>9} "
              f"{'fold/plain':>10} {'dev':>6}")
        for h, cin, cout in cases:
            row = case_times(h, cin, cout, device, args.iters)
            for side in ("plain", "folded"):
                for key in ("ms", "device_ms"):
                    if totals[side][key] is not None:
                        totals[side][key] += row[side][key]
            rows.append(row)
            print(_line(row["case"], row), flush=True)
            if on_card:
                torch.cuda.empty_cache()
        print(_line("TOTAL", totals), flush=True)
    record = {
        "script": "ab_convfold", "cases": "xl" if args.xl else "sd", "dtype": "bfloat16",
        "iters": args.iters, "platform": benchkit.platform(device),
        "device": benchkit.device_record() if on_card else None,
        "backend_flags": benchkit.backend_flags(), "pin": pin, "rows": rows,
        "total": {**totals, "fold_over_plain": totals["folded"]["ms"] / totals["plain"]["ms"],
                  "device_fold_over_plain": (totals["folded"]["device_ms"]
                                             / totals["plain"]["device_ms"] if on_card else None)},
    }
    print(json.dumps(record), flush=True)
    return record


def _line(label: str, row: dict) -> str:
    p, f = row["plain"], row["folded"]
    dev = (f"{p['device_ms']:9.4f} ", f"{f['device_ms']:9.4f} ",
           f"{f['device_ms'] / p['device_ms']:6.2f}") if p["device_ms"] is not None else (
        f"{'-':>9} ", f"{'-':>9} ", f"{'-':>6}")
    return (f"{label:>24} {p['ms']:9.4f} {dev[0]}{f['ms']:10.4f} {dev[1]}"
            f"{f['ms'] / p['ms']:10.2f} {dev[2]}")


if __name__ == "__main__":
    main()
