"""Tensor parallelism: the Megatron rules of the JAX package on the port's
module names.

Counterpart of `leco_tpu/parallel/sharding.py`. In the transformer blocks
only, and never on a LoRA leaf:

  column-parallel (torch weight dim 0 and the bias sharded): attn `to_q`,
    `to_k`, `to_v` (the heads split over tp) and the GEGLU `proj` (the FF
    hidden split);
  row-parallel (weight dim 1 sharded, bias replicated and added once after
    the reduce): attn `to_out.0` and ff `net.2`.

`param_spec` is the JAX table (`unet_param_spec` :46-62 with
`shard_unet_params`'s guard that the dim divide tp, :65-80) mapped through
`flax_unet_to_torch`: a flax kernel is (in, out), a torch weight (out, in).

Where the port differs from GSPMD, which reshards whatever it is given:
  * a layer is sharded with the rest of its unit or not at all: an
    attention's q/k/v/out on whole heads only (SD2.1's 5 heads of 64 at
    level 0 stay replicated at tp 2; GSPMD would reshard them), a
    feed-forward's `proj` and `net.2` together;
  * the GEGLU `proj`'s output is [value | gate]: each half is sharded on its
    own, so that a rank holds matching value and gate columns and its local
    output is again [value_local | gate_local].

The LoRA leaves stay replicated, as in JAX. A column-parallel layer adds
(x·down)·up[local rows]; a row-parallel one all-reduces its rank-r partial
x_local·down[:, local cols] before `up`. `reduce_lora_grads` (in
`context.py`) sums the partial gradients over tp: both leaves of a
column-parallel layer and the `down` of a row-parallel one; the rest are
computed alike on every tp rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from leco_tpu_torch.parallel import collectives as C
from leco_tpu_torch.parallel.mesh import TP_AXIS

COLUMN = "column"
ROW = "row"
_COLUMN_LAYERS = ("to_q", "to_k", "to_v", "proj")
_ROW_LAYERS = ("to_out.0", "net.2")


def _in_transformer(layer: str) -> bool:
    return "attentions" in layer.split(".")


def layer_kind(layer: str) -> Optional[str]:
    """COLUMN, ROW or None for a module name (the JAX rule's layer names)."""
    if not _in_transformer(layer):
        return None
    if layer.rsplit(".", 1)[-1] in _COLUMN_LAYERS:
        return COLUMN
    if any(layer.endswith("." + name) for name in _ROW_LAYERS):
        return ROW
    return None


def param_spec(name: str, shape, tp: int) -> Optional[int]:
    """The torch dim of state-dict entry `name` that the JAX rule shards
    over tp, or None (replicated)."""
    layer, leaf = name.rsplit(".", 1)
    kind = layer_kind(layer)
    dim = None
    if kind == COLUMN and leaf in ("weight", "bias"):
        dim = 0
    elif kind == ROW and leaf == "weight":
        dim = 1
    if dim is not None and shape[dim] % tp:
        return None
    return dim


def _sharded(module, layer: str, tp: int) -> bool:
    # a column-parallel bias has the weight's dim 0, so the weight decides
    return param_spec(f"{layer}.weight", module.weight.shape, tp) is not None


def tp_plan(unet: torch.nn.Module, tp: int) -> dict[str, str]:
    """{layer name: COLUMN or ROW} of the layers that shard at `tp`: each
    attention whose heads divide tp and whose four layers the JAX rule
    shards, and each feed-forward whose GEGLU halves divide tp and whose two
    layers it shards."""
    plan: dict[str, str] = {}
    if tp == 1:
        return plan
    for name, mod in unet.named_modules():
        if not _in_transformer(name):
            continue
        units = None
        if all(hasattr(mod, a) for a in ("to_q", "to_k", "to_v", "to_out")):
            if mod.heads % tp == 0:
                units = [f"{name}.to_q", f"{name}.to_k", f"{name}.to_v", f"{name}.to_out.0"]
        elif hasattr(mod, "net") and hasattr(mod.net[0], "proj"):
            if (mod.net[0].proj.out_features // 2) % tp == 0:
                units = [f"{name}.net.0.proj", f"{name}.net.2"]
        if units and all(_sharded(unet.get_submodule(u), u, tp) for u in units):
            plan.update({u: layer_kind(u) for u in units})
    return plan


def local_index(layer: str, kind: str, size: int, tp: int, index: int) -> torch.Tensor:
    """This rank's rows (COLUMN: of the output) or columns (ROW: of the
    input) of a sharded layer whose sharded dim is `size`; the GEGLU `proj`
    takes its share of the value half and the same share of the gate half."""
    if layer.endswith(".proj"):
        half = size // 2
        part = torch.arange(index * half // tp, (index + 1) * half // tp)
        return torch.cat([part, part + half])
    return torch.arange(index * size // tp, (index + 1) * size // tp)


def shard_unet_state(state: dict, plan: dict[str, str], tp: int, index: int) -> dict:
    """A full state dict -> this tp rank's: each planned layer's weight
    (and a column-parallel layer's bias) cut to the rank's share; every
    other entry, the LoRA leaves included, as it is."""
    out = dict(state)
    for layer, kind in plan.items():
        w = state[f"{layer}.weight"]
        dim = 0 if kind == COLUMN else 1
        idx = local_index(layer, kind, w.shape[dim], tp, index).to(w.device)
        out[f"{layer}.weight"] = w.index_select(dim, idx)
        if kind == COLUMN and f"{layer}.bias" in state:
            out[f"{layer}.bias"] = state[f"{layer}.bias"].index_select(0, idx)
    return out


@torch.no_grad()
def shard_unet(unet: torch.nn.Module, mesh) -> dict[str, str]:
    """Cut the planned layers' base weights of `unet` to this rank's share
    in place, mark each with its role and local index (for the LoRA
    factors), and give each sharded attention its local head count ->
    the plan."""
    tp, index = mesh.axis_size(TP_AXIS), mesh.axis_index(TP_AXIS)
    plan = tp_plan(unet, tp)
    state = {k: v for k, v in unet.state_dict().items()
             if k.rsplit(".", 1)[0] in plan and not k.rsplit(".", 1)[1].startswith("lora_")}
    local = shard_unet_state(state, plan, tp, index)
    for layer, kind in plan.items():
        mod = unet.get_submodule(layer)
        mod.weight = torch.nn.Parameter(local[f"{layer}.weight"], requires_grad=False)
        if kind == COLUMN and mod.bias is not None:
            mod.bias = torch.nn.Parameter(local[f"{layer}.bias"], requires_grad=False)
        size = mod.out_features if kind == COLUMN else mod.in_features
        mod.tp_role = kind
        mod.tp_index = local_index(layer, kind, size, tp, index).to(mod.weight.device)
    for name, mod in unet.named_modules():
        if f"{name}.to_q" in plan:
            mod.heads //= tp
    return plan


def linear(layer, x: torch.Tensor) -> torch.Tensor:
    """A tp-sharded LoRALinear's forward (its base weight already this
    rank's share)."""
    group = layer.parallel.mesh.group(TP_AXIS)
    dt = x.dtype
    if layer._branch_on():
        down, up = layer.lora_factors()
    w = layer._weight().to(dt)
    bias = None if layer.bias is None else layer.bias.to(dt)
    if layer.tp_role == COLUMN:
        x = C.copy_to_group(x, group)
        y = F.linear(x, w, bias)
        if layer._branch_on():
            y = y + F.linear(F.linear(x, down.to(dt)), up.to(dt)) * layer.lora_scale
        return y
    # the partial products sum in fp32, as the unsharded GEMM accumulates
    y = C.reduce_from_group(F.linear(x, w).float(), group)
    if bias is not None:
        y = y + layer.bias.float()
    y = y.to(dt)
    if layer._branch_on():
        h = C.reduce_from_group(F.linear(x, down.to(dt)).float(), group).to(dt)
        y = y + F.linear(h, up.to(dt)) * layer.lora_scale
    return y


def column_input(layer, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel layer (Megatron's f), for the GEGLU
    projection's own forward."""
    return C.copy_to_group(x, layer.parallel.mesh.group(TP_AXIS))
