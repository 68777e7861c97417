"""Process-group start-up and the run's shared seed.

Counterpart of `leco_tpu/parallel/distributed.py` and the JAX trainer's
`_multihost_shared_seed` (`trainer.py:421-435`).

`maybe_initialize_distributed(device)` starts torch.distributed from a
launcher's environment (torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT): NCCL for a CUDA device, each rank on
`cuda:LOCAL_RANK`, and gloo for the CPU. With no such environment it does
nothing. A failed start raises: a rank that trained alone would be a hidden
fallback (the JAX version prints and carries on).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def maybe_initialize_distributed(device) -> torch.device:
    """Start the default process group when a launcher's environment is
    present -> this rank's device (`cuda:LOCAL_RANK` for a CUDA device, the
    given device otherwise, and the given device unchanged when there is no
    launcher)."""
    device = torch.device(device)
    if not all(os.environ.get(k) for k in LAUNCHER_VARIABLES):
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    except Exception as e:
        raise RuntimeError(f"torch.distributed ({backend}) did not start from the launcher's "
                           f"environment: {e}") from e
    return device


def from_rank0(obj):
    """Rank 0's `obj` on every rank (pickled; other ranks' `obj` is
    ignored). At world size 1, `obj` itself."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shared_seed(seed: Optional[int], device=None) -> Optional[int]:
    """Every rank must draw the same (pair, timesteps_to, resolution)
    sequence and the same latents, or the collectives of the sharded step
    fall out of step. At world size 1 the seed passes through (None stays
    unseeded, the reference's behaviour); a configured seed is already
    shared; with None, rank 0 draws from OS entropy and broadcasts its
    draw. `device` is where the broadcast's tensor lives (NCCL needs CUDA)."""
    if world_size() == 1 or seed is not None:
        return seed
    draw = torch.tensor([int(np.random.SeedSequence().entropy % 2**63)], dtype=torch.int64,
                        device=device)
    dist.broadcast(draw, src=0)
    return int(draw.item())
