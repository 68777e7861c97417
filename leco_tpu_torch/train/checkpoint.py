"""Full train-state checkpoint and resume.

Counterpart of `leco_tpu/train/checkpoint.py`, with `torch.save` in place of
orbax and the same layout: `<save.path>/state/step_<iteration>/` holds the
state (`state.pt`: the LoRA tensors, the optimizer's `state_dict()`, the
iteration, the torch generator's state, the counterpart of the JAX
package's PRNG key, and the EMA tree if there is one), and
`step_<iteration>.rng.json` beside it holds the numpy PCG64 state of the
host's sampling stream plus `has_ema`. The AddNet `.safetensors` exports
are separate and unchanged. Snapshots past the newest
`LECO_KEEP_SNAPSHOTS` (default 3, 0 keeps all) are deleted after each save,
never the one just written.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _host(tree: Optional[dict]) -> Optional[dict]:
    return None if tree is None else {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def save_train_state(directory: str | os.PathLike, *, lora: dict, optimizer: dict,
                     iteration: int, generator_state: torch.Tensor, rng: np.random.Generator,
                     ema: Optional[dict] = None) -> str:
    """Snapshot everything needed to resume after `iteration`. `optimizer`
    is the optimizer's `state_dict()`; `ema` (optional) the EMA tree, whose
    presence the sidecar records."""
    directory = os.fspath(directory)
    path = os.path.join(os.path.abspath(directory), f"step_{iteration}")
    os.makedirs(path, exist_ok=True)
    state = {"lora": _host(lora), "optimizer": optimizer, "iteration": int(iteration),
             "generator": generator_state.to("cpu")}
    if ema is not None:
        state["ema"] = _host(ema)
    target = os.path.join(path, STATE_FILE)
    torch.save(state, target + ".tmp")
    os.replace(target + ".tmp", target)
    # the host RNG's PCG64 state holds 128-bit integers: a JSON sidecar
    sidecar = dict(rng.bit_generator.state)
    sidecar["has_ema"] = ema is not None
    with open(path + ".rng.json", "w") as f:
        json.dump(sidecar, f)
    gc_snapshots(directory, protect=iteration)
    return path


def gc_snapshots(directory: str | os.PathLike, keep_last: Optional[int] = None,
                 protect: Optional[int] = None) -> None:
    """Delete all but the newest `keep_last` step_* snapshots (default 3,
    LECO_KEEP_SNAPSHOTS overrides; 0 disables). `protect` names a step
    that is never deleted: the one just written, even when a run restarted
    with a reset iteration counter finds older higher-numbered snapshots."""
    if keep_last is None:
        keep_last = int(os.environ.get("LECO_KEEP_SNAPSHOTS", "3"))
    if keep_last <= 0:
        return
    directory = os.path.abspath(os.fspath(directory))
    if not os.path.isdir(directory):
        return
    steps = sorted(
        s for s in (
            int(n.split("_", 1)[1])
            for n in os.listdir(directory)
            if n.startswith("step_") and not n.endswith(".json")
            and n.split("_", 1)[1].isdigit()
        )
    )
    for s in steps[:-keep_last]:
        if protect is not None and s == protect:
            continue
        path = os.path.join(directory, f"step_{s}")
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".rng.json")
        except OSError:
            pass


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_train_state(directory: str | os.PathLike,
                        iteration: Optional[int] = None) -> Optional[dict]:
    """The latest (or a given) snapshot, or None if there is none:
    {"lora", "optimizer", "iteration", "generator", "rng"[, "ema"]}, the
    tensors on the CPU (`to_device` places the LoRA and EMA)."""
    directory = os.fspath(directory)
    step = iteration if iteration is not None else latest_step(directory)
    if step is None:
        return None
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    with open(path + ".rng.json") as f:
        sidecar = json.load(f)
    has_ema = sidecar.pop("has_ema", False)
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if has_ema != ("ema" in state):
        raise ValueError(f"{path}: the sidecar's has_ema ({has_ema}) and the state disagree")
    state["rng"] = _decode_rng(sidecar)
    return state


def to_device(state: dict, device) -> dict:
    """A restored state with its LoRA (and EMA) tensors on `device`."""
    for key in ("lora", "ema"):
        if key in state:
            state[key] = {k: v.to(device) for k, v in state[key].items()}
    return state


def _decode_rng(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    if state["bit_generator"] != rng.bit_generator.state["bit_generator"]:
        raise ValueError(f"unsupported bit generator {state['bit_generator']}")
    rng.bit_generator.state = state
    return rng
