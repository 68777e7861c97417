"""Memory hygiene: `flush()` returns the CUDA caching allocator's unused
blocks to the device and collects garbage, as the reference's `flush.py`
does (`torch.cuda.empty_cache()`, then `gc.collect()`), e.g. between two
models in one process. Without a GPU it only collects garbage.

    python -m leco_tpu_torch.flush
"""

import gc

import torch


def flush() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    gc.collect()


if __name__ == "__main__":
    flush()
