"""Process meshes: the JAX package's device meshes over torch.distributed
ranks.

Counterpart of `leco_tpu/parallel/mesh.py` and `sharding.make_mesh_2d`. A
`ProcessMesh` is a 2-D grid of ranks, (dp, tp) or (dp, sp), in the JAX
device order: the ranks reshaped to (world // inner, inner), so the tp or sp
ranks of one dp index are consecutive (`mesh.py:38-40`, `sharding.py:35-38`).
It holds one process group per axis for this rank and an explicit device:
it never assumes `cuda:<rank>`, so several ranks may share one card.

`internal_plan` is `constrain_internal`'s decision (`mesh.py:47-63`) for an
NCHW shape: the leading batch dim over dp where it divides, H (dim 2) over
sp where it divides. `mesh_axes` is the JAX CLIs' choice of mesh
(`train_lora.py:90-107`, `train_lora_xl.py:87-89`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"


def rank_grid(world_size: int, inner: int) -> np.ndarray:
    """Ranks 0..world-1 as the (world // inner, inner) grid of the JAX
    meshes."""
    if inner < 1 or world_size % inner:
        raise ValueError(f"an inner axis of {inner} does not divide {world_size} processes")
    return np.arange(world_size).reshape(world_size // inner, inner)


class ProcessMesh:
    """The (dp, `inner_axis`) grid of the world's ranks, this rank's
    coordinates and one process group per axis of size > 1 (None for an
    axis of size 1, whose collectives are the identity)."""

    def __init__(self, inner_axis: str, inner: int, device):
        if inner_axis not in (TP_AXIS, SP_AXIS):
            raise ValueError(f"unknown mesh axis {inner_axis}")
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        self.rank = dist.get_rank() if initialized else 0
        grid = rank_grid(world, inner)
        self.device = torch.device(device)
        self.shape = {DP_AXIS: grid.shape[0], inner_axis: grid.shape[1]}
        i, j = divmod(self.rank, inner)
        self.coords = {DP_AXIS: i, inner_axis: j}
        self.groups: dict = {DP_AXIS: None, inner_axis: None}
        # torch.distributed wants every rank to create every group, in one order
        for axis, lines in ((DP_AXIS, grid.T), (inner_axis, grid)):
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == 1:
                    continue
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[axis] = group

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def group(self, name: str):
        return self.groups.get(name)

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def dp_size(mesh: Optional[ProcessMesh]) -> int:
    return 1 if mesh is None else mesh.axis_size(DP_AXIS)


def shardable_batch(batch_size: int, mesh: Optional[ProcessMesh]) -> bool:
    """The JAX rule (`mesh.py:78-85`): a batch shards when it divides dp."""
    if mesh is None:
        return False
    return batch_size % dp_size(mesh) == 0


def internal_plan(shape, mesh: Optional[ProcessMesh]) -> tuple:
    """`constrain_internal`'s sharding of an NCHW activation -> one entry
    per dim, the axis name it shards over or None: dim 0 over dp when it
    divides dp, H (dim 2 of NCHW, dim 1 of the JAX package's NHWC) over sp
    when it divides sp."""
    spec = [None] * len(shape)
    if mesh is None:
        return tuple(spec)
    dp, sp = mesh.axis_size(DP_AXIS), mesh.axis_size(SP_AXIS)
    if dp > 1 and shape[0] % dp == 0:
        spec[0] = DP_AXIS
    if sp > 1 and len(shape) == 4 and shape[2] % sp == 0:
        spec[2] = SP_AXIS
    return tuple(spec)


def mesh_axes(data_parallel: bool, tensor_parallel: int, spatial_parallel: int,
              world_size: int, xl: bool = False) -> Optional[tuple[str, int]]:
    """The JAX CLIs' mesh for a train config -> (inner axis, its size), or
    None for no mesh. sp and tp are exclusive; `spatial_parallel: 0` is
    auto, sp = max(1, n // 2) (dp takes the CFG batch's factor 2); with
    `data_parallel: false`, tp 1 and sp 1 there is no mesh. SDXL takes dp
    and tp only (the JAX XL CLI has no sp mesh; the port refuses sp there
    rather than ignore it)."""
    if spatial_parallel != 1 and tensor_parallel > 1:
        raise ValueError("spatial_parallel and tensor_parallel are exclusive")
    if spatial_parallel != 1:
        if xl:
            raise ValueError("train.spatial_parallel != 1: SDXL takes data and tensor "
                             "parallelism only")
        sp = max(1, world_size // 2) if spatial_parallel == 0 else spatial_parallel
        if sp < 1 or world_size % sp:
            raise ValueError(f"train.spatial_parallel != 1: sp {sp} does not divide the "
                             f"{world_size} processes")
        return SP_AXIS, sp
    if data_parallel or tensor_parallel > 1:
        if world_size % tensor_parallel:
            raise ValueError(f"train.tensor_parallel > 1: tp {tensor_parallel} does not "
                             f"divide the {world_size} processes")
        return TP_AXIS, tensor_parallel
    return None
