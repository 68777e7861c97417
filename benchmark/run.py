"""The benchmark of the PyTorch and CUDA port (`leco_tpu_torch`) on an
NVIDIA H100: LoRA erase training of SD1.5 and SDXL.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics; both decide `correct` against
the plain reference in `benchmark/reference/`. The last line of standard
output is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each compared
number beside its limit, which also end standard error). Without a CUDA
device, or with fewer than the cell asks for, it exits non-zero and prints
no result. Build and kernel caches stay in fixed directories of the
checkout (`leco_tpu_torch/kernels/_build/`, `.bench_cache/`).
"""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402

if __name__ == "__main__":
    started = harness.process_start()
    cache = HERE.parent / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.exit(harness.main(sys.argv[1:], started))
