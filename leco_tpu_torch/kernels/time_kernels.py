"""Device times of the GEGLU and GroupNorm kernels of one or more checkouts,
in turns, all measured with this tree's helper (`timing.py`), so that a
checkout whose own chip_smoke reports no device time can be measured the same
way as this one, on the same card, in the same call.

    python -m leco_tpu_torch.kernels.time_kernels TREE [TREE ...]

Each TREE is the root of a checkout of this repository ("." for this one),
built and timed in a subprocess of its own in the order given (for an A/B:
parent, change, change, parent). For each it prints one JSON line per shape:
`geglu_gemm` at SD1.5's three GEGLU levels at batch 2 (no LoRA) beside
`F.linear(x, W, b)`, the GEMM alone; `group_norm_silu` at chip_smoke's
GroupNorm shapes without SiLU beside `F.group_norm`, each rotated over
enough input copies to exceed twice the L2. Then the card's name and power
limit. Needs one CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

# (M, K, N): SD1.5's GEGLU levels 0-2 at batch 2 (B·tokens rows)
GEGLU_SHAPES = [(2 * 4096, 320, 1280), (2 * 1024, 640, 2560), (2 * 256, 1280, 5120)]
# (B, C, H, W, eps): chip_smoke's GroupNorm shapes without SiLU
GN_SHAPES = [(2, 320, 64, 64, 1e-6), (2, 640, 32, 32, 1e-6), (2, 1280, 16, 16, 1e-6),
             (2, 1280, 8, 8, 1e-6), (3, 320, 64, 64, 1e-6), (1, 320, 64, 64, 1e-6)]


def _timing():
    """This tree's timing helper, loaded from its file so that the checkout
    under test supplies everything else."""
    spec = importlib.util.spec_from_file_location(
        "leco_device_timing", Path(__file__).with_name("timing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_tree(tree: str) -> None:
    """Build and time the kernels of the checkout at `tree` (run in a
    process of its own: it imports that checkout's `leco_tpu_torch`)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import torch.nn.functional as F

    from leco_tpu_torch.kernels.build import library
    from leco_tpu_torch.ops import geglu
    from leco_tpu_torch.ops import group_norm as gn

    timing = _timing()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    gen = torch.Generator(device).manual_seed(0)
    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=device)
    for _ in range(100):  # the clocks up before the first timing
        a @ a
    torch.cuda.synchronize()
    del a
    for m, k, n in GEGLU_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        w = (torch.randn((2 * n, k), generator=gen, device=device) * k**-0.5).bfloat16()
        b = torch.randn((2 * n,), generator=gen, device=device)
        b16 = b.bfloat16()
        print(json.dumps({"tree": tree, "kernel": "geglu", "shape": [m, k, n, 0],
                          "device_ms": timing.device_ms(lambda: geglu.geglu_gemm(x, w, b)),
                          "gemm_alone_device_ms": timing.device_ms(
                              lambda: F.linear(x, w, b16))}), flush=True)
    for bsz, c, h, w_, eps in GN_SHAPES:
        x = (torch.randn((bsz, c, h, w_), generator=gen, device=device) * 2).bfloat16()
        scale = 1 + 0.1 * torch.randn((c,), generator=gen, device=device)
        shift = 0.1 * torch.randn((c,), generator=gen, device=device)
        s16, h16 = scale.bfloat16(), shift.bfloat16()
        copies = [x.clone() for _ in range(timing.rotation_count(x.numel() * 2))]
        kernel = [lambda t=t: gn.group_norm_silu(t, scale, shift, 32, eps, False) for t in copies]
        library_call = [lambda t=t: F.group_norm(t, 32, s16, h16, eps) for t in copies]
        print(json.dumps({"tree": tree, "kernel": "group_norm", "shape": [bsz, c, h, w_, eps],
                          "l2_rotation_copies": len(copies),
                          "device_ms": timing.device_ms(kernel),
                          "library_device_ms": timing.device_ms(library_call)}), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        time_tree(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    for tree in argv:
        done = subprocess.run([sys.executable, __file__, "--one", tree])
        if done.returncode != 0:
            return done.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
