"""The parallel context a UNet holds (`UNet2DConditionModel.set_parallel`).

A `ParallelContext` joins a `ProcessMesh` to the UNet's layers: the layers
read it, and nothing changes where it is absent. `call` runs one UNet call
sharded as `constrain_internal` shards its input (`mesh.internal_plan`): the
batch over dp where it divides dp, the latent H over sp where it divides sp
at every level of the UNet. Where a level's H does not divide sp (a 576 px
bucket's 72 / 36 / 18 / 9 at sp 2), the whole call runs with H replicated
over sp, as `constrain_internal` leaves an indivisible H. Applied to every
UNet input of the step, this is what the JAX trainer's `shard_batch` and
`shard_internal` do (`trainer.py:875-889`): a logical batch that divides dp
shards everywhere; otherwise the CFG 2B and the 3B references shard where
they divide.

The step's inputs and outputs are global tensors, the same on every rank
(the latents are drawn from one shared generator); `call` cuts this rank's
share, runs the layers on it, and gathers the output unless asked for the
local share (the differentiated target, whose loss is taken from local
sums: `esd_loss`). `reduce_lora_grads` then gives every rank the full
gradient.

Under tp or sp the JAX package's fused-kernel knobs are refused
(`check_knobs`): their kernels would see sharded tensors no test has held
them to (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from leco_tpu_torch.parallel import collectives as C
from leco_tpu_torch.parallel.mesh import DP_AXIS, SP_AXIS, TP_AXIS, ProcessMesh, internal_plan

# the knobs whose kernels have not been held to sharded shapes
REFUSED_KNOBS = {"LECO_FLASH_PACKED": "1", "LECO_RESNET_FUSED": "1", "LECO_TPU_FUSED_GN": "1",
                 "LECO_GEGLU": "fused", "LECO_CONV_BACKEND": "gemm"}


def attach(module: torch.nn.Module, ctx: "ParallelContext | None") -> None:
    """Give `module` and every submodule that reads a parallel context
    (those with a `parallel` attribute) `ctx`, or None."""
    for mod in module.modules():
        if hasattr(mod, "parallel"):
            mod.parallel = ctx


@dataclasses.dataclass(frozen=True)
class CallPlan:
    """How one UNet call is sharded: its batch over dp, its H over sp."""

    batch: bool
    spatial: bool


class ParallelContext:
    def __init__(self, mesh: ProcessMesh, levels: int):
        self.mesh = mesh
        self.levels = levels
        self.spatial = False  # the call in flight has its H split over sp
        self.check_knobs()

    @property
    def dp(self) -> int:
        return self.mesh.axis_size(DP_AXIS)

    @property
    def sp(self) -> int:
        return self.mesh.axis_size(SP_AXIS)

    @property
    def tp(self) -> int:
        return self.mesh.axis_size(TP_AXIS)

    def check_knobs(self) -> None:
        if self.tp == 1 and self.sp == 1:
            return
        for knob, value in REFUSED_KNOBS.items():
            if os.environ.get(knob) == value:
                raise NotImplementedError(
                    f"{knob}={value} under tensor or spatial parallelism is not ported "
                    "(ROADMAP.md queue 1, the knobs under tp and sp)")

    def plan(self, shape) -> CallPlan:
        spec = internal_plan(shape, self.mesh)
        spatial = (spec[2] == SP_AXIS
                   and shape[2] % (self.sp * 2 ** (self.levels - 1)) == 0)
        return CallPlan(batch=spec[0] == DP_AXIS, spatial=spatial)

    def local(self, x, plan: CallPlan, spatial: bool = True):
        """This rank's share of a global tensor: its dp slice of dim 0 and,
        for an NCHW latent (`spatial`), its sp rows of dim 2."""
        if x is None or not torch.is_tensor(x) or x.ndim == 0:
            return x
        if plan.batch:
            b = x.shape[0] // self.dp
            x = x.narrow(0, self.mesh.axis_index(DP_AXIS) * b, b)
        if spatial and plan.spatial:
            h = x.shape[2] // self.sp
            x = x.narrow(2, self.mesh.axis_index(SP_AXIS) * h, h)
        return x.contiguous()

    def gather(self, x: torch.Tensor, plan: CallPlan) -> torch.Tensor:
        if plan.spatial:
            x = C.all_gather(x, 2, self.mesh.group(SP_AXIS))
        if plan.batch:
            x = C.all_gather(x, 0, self.mesh.group(DP_AXIS))
        return x

    def bound(self, fn):
        """`fn` run with this call's `spatial` (for a checkpointed block,
        whose forward runs again in the backward, after the call)."""
        spatial = self.spatial

        def run(*args):
            saved, self.spatial = self.spatial, spatial
            try:
                return fn(*args)
            finally:
                self.spatial = saved

        return run

    def call(self, fn, sample, timesteps, encoder_hidden_states, added_cond_kwargs=None,
             gather: bool = True):
        """One UNet call `fn(sample, timesteps, ehs, added)` (the local
        forward) on this rank's share -> (the output, global or with
        `gather=False` this rank's share, the plan)."""
        self.check_knobs()
        plan = self.plan(sample.shape)
        if torch.is_tensor(timesteps) and timesteps.ndim > 0:
            timesteps = self.local(timesteps, plan, spatial=False)
        added = None if added_cond_kwargs is None else {
            k: self.local(v, plan, spatial=False) for k, v in added_cond_kwargs.items()}
        self.spatial = plan.spatial
        try:
            out = fn(self.local(sample, plan), timesteps,
                     self.local(encoder_hidden_states, plan, spatial=False), added)
        finally:
            self.spatial = False
        return (self.gather(out, plan) if gather else out), plan

    def reduction_groups(self, plan: CallPlan) -> list:
        """The groups a loss or gradient over `plan`'s shares sums over."""
        groups = []
        if plan.spatial:
            groups.append(self.mesh.group(SP_AXIS))
        if plan.batch:
            groups.append(self.mesh.group(DP_AXIS))
        return groups

    def esd_loss(self, target, positive, unconditional, neutral, guidance_scale: float,
                 erase_sign: float, plan: CallPlan) -> torch.Tensor:
        """`prompts.esd_loss` (the mean over every element, fp32) of a call
        whose `target` is this rank's share; the three references are the
        global tensors. Each rank's backward is that of its local sum."""
        positive, unconditional, neutral = (self.local(x, plan).float()
                                            for x in (positive, unconditional, neutral))
        goal = neutral - erase_sign * guidance_scale * (positive - unconditional)
        total = ((target.float() - goal) ** 2).sum()
        count = target.numel()
        for group in self.reduction_groups(plan):
            total = C.reduce_from_group(total, group)
            count *= C.group_size(group)
        return total / count

    @torch.no_grad()
    def reduce_lora_grads(self, layers, plan: CallPlan) -> None:
        """Sum each LoRA leaf's gradient over the axes where this rank's is a
        partial: sp and dp where the target call was sharded over them, and
        tp for both leaves of a column-parallel layer and the `down` of a
        row-parallel one. A leaf replicated over an axis has the same
        gradient on every rank of it already. `layers`: (name, layer)."""
        groups = self.reduction_groups(plan)
        shared, tp_partial = [], []
        for _, layer in layers:
            for leaf in ("lora_down", "lora_up"):
                p = getattr(layer, leaf)
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                role = getattr(layer, "tp_role", None)
                partial = role == "column" or (role == "row" and leaf == "lora_down")
                (tp_partial if partial else shared).append(p.grad)
        for group in groups:
            C.sum_tensors(shared + tp_partial, group)
        C.sum_tensors(tp_partial, self.mesh.group(TP_AXIS))
