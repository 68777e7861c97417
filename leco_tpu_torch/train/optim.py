"""Optimizer + LR-schedule factories.

Counterpart of `leco_tpu/train/optim.py` (reference train_util.py:333-401).
Every name the JAX package takes is ported:

  name        JAX package (optax)             here
  ---------   -----------------------------   --------------------------------
  adam        optax.adam                      `Adam`
  adamw       optax.adamw (wd 0.01)           torch.optim.AdamW (wd 0.01)
  lion        optax.lion (wd 0.0)             `Lion`
  prodigy     optax.contrib.prodigy           `Prodigy`
  dadaptadam  optax.contrib.dadapt_adamw      `DAdaptAdam`
  dadaptlion  train/dadapt.py                 `train/dadapt.py::DAdaptLion`
  adam8bit    train/quant8.py                 `train/quant8.py::Adam8bit`
  lion8bit    train/quant8.py                 `train/quant8.py::Lion8bit`

Each of the hand-written ones is a `TreeOptimizer`: one parameter group
over the LoRA tree, whose `step()` is the optax transformation's update
followed by `apply_updates`, with optax's argument names (b1, b2, ...) and
defaults. The `optimizer_args` mini-DSL maps torch's `betas` to (b1, b2) as
the JAX package does; an argument the optax function does not take raises
TypeError, as it does there. Prodigy and D-Adapt Adam take `betas` as the
reference's torch classes do (the JAX package passes b1/b2 to them, which
optax refuses; ROADMAP.md queue 3).

The learning rate is `param_groups[0]["lr"]`: the trainer sets it to the
schedule's value at iteration j before the j-th `step()`, which is where
optax evaluates a schedule (at the update's own count, starting at 0).
The schedules are evaluated in float32, as `jnp` evaluates them; the
constant schedule returns the configured lr itself.
"""

from __future__ import annotations

import ast
from typing import Callable, Iterable, Optional

import numpy as np
import torch


def parse_optimizer_args(optimizer_args: str) -> dict:
    """'k1=v1 k2=v2' -> dict via ast.literal_eval (train_lora.py:82-89)."""
    kwargs = {}
    if optimizer_args:
        for arg in optimizer_args.split(" "):
            if not arg:
                continue
            key, value = arg.split("=")
            kwargs[key] = ast.literal_eval(value)
    return kwargs


def _map_torch_kwargs(kwargs: dict) -> dict:
    """torch's `betas` -> optax's b1/b2 (`leco_tpu/train/optim.py:47-53`)."""
    out = dict(kwargs)
    if "betas" in out:
        b1, b2 = out.pop("betas")
        out["b1"] = b1
        out["b2"] = b2
    return out


def get_lr_schedule(name: Optional[str], lr: float, max_iterations: Optional[int],
                    lr_min: Optional[float] = None) -> Callable[[int], float]:
    """Schedule fn(step) -> lr (train_util.py:373-401; lr_min = lr/100 as
    train_lora.py:90-95 passes it). The four shaped schedules compute in
    float32 with the JAX package's formulas, so a value equals
    `float(schedule(step))` there up to the last bit of a float32 cos."""
    f32 = np.float32
    if lr_min is None:
        lr_min = lr / 100
    if name == "constant" or name is None:
        return lambda step: lr

    def cos(x: np.float32) -> np.float32:
        # the correctly rounded float32 cosine, which XLA's agrees with
        # more often than numpy's float32 one
        return f32(np.cos(np.float64(x)))

    if name == "cosine":
        def cosine(step: int) -> float:
            t = f32(min(step, max_iterations))
            c = cos(f32(np.pi) * t / f32(max_iterations))
            return float(f32(lr_min) + f32(lr - lr_min) * f32(0.5) * (f32(1) + c))

        return cosine

    if name == "cosine_with_restarts":
        t0 = f32(max(max_iterations // 10, 1))

        def cosine_with_restarts(step: int) -> float:
            # cycle k has length T_0 * 2^k and starts at T_0 * (2^k - 1)
            s = f32(step)
            k = np.floor(np.log2(s / t0 + f32(1)))
            power = f32(2) ** k
            t_cur = s - t0 * (power - f32(1))
            c = cos(f32(np.pi) * t_cur / (t0 * power))
            return float(f32(lr_min) + f32(lr - lr_min) * f32(0.5) * (f32(1) + c))

        return cosine_with_restarts

    if name == "step":
        step_size = f32(max(max_iterations // 100, 1))
        return lambda step: float(f32(lr) * f32(0.999) ** np.floor(f32(step) / step_size))

    if name == "linear":
        total = f32(max(max_iterations // 100, 1))

        def linear(step: int) -> float:
            frac = np.clip(f32(step) / total, f32(0), f32(1))
            return float(f32(lr) * (f32(0.5) + f32(0.5) * frac))

        return linear

    raise ValueError(
        "Scheduler must be cosine, cosine_with_restarts, step, linear or constant"
    )


# ---------------------------------------------------------------------------
# optimizers over the LoRA tree
# ---------------------------------------------------------------------------


def _tree_sum(leaves: list) -> torch.Tensor:
    """The sum of every element of every leaf, as a 0-d fp32 device tensor:
    one fp64 reduction over the leaves laid end to end, rounded once, so
    that the CPU and the card, which sum in other orders, agree on the
    result as a rule (the JAX package sums in fp32)."""
    return torch.cat([x.reshape(-1) for x in leaves]).double().sum().float()


def tree_dot(a: list, b: list) -> torch.Tensor:
    """Sum over leaves of <a_i, b_i> (fp32 products, summed as `_tree_sum`)."""
    return _tree_sum(torch._foreach_mul([x.float() for x in a], [y.float() for y in b]))


def tree_l1(a: list) -> torch.Tensor:
    """Sum over leaves of |a_i|_1."""
    return _tree_sum(torch._foreach_abs([x.float() for x in a]))


def bias_correction(b: float, count: int) -> float:
    """1 - b**count in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(b) ** np.float32(count))


class TreeOptimizer(torch.optim.Optimizer):
    """One parameter group over the LoRA tree, stepped as one optax update.

    Per-leaf state lives in `self.state[p]`; what the leaves share (the
    update count, a Python int, and the D-Adaptation family's scalars, 0-d
    device tensors) lives in the first leaf's state, so `state_dict()`
    carries it and `load_state_dict()` moves it to the parameters' device.
    A leaf without a gradient takes a zero gradient, as a JAX gradient of
    an unused leaf is zero. Subclasses implement `init_state` and `update`.
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: float, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one parameter group")

    @property
    def leaves(self) -> list[torch.Tensor]:
        return self.param_groups[0]["params"]

    @property
    def shared(self) -> dict:
        return self.state[self.leaves[0]]

    def init_state(self, params: list[torch.Tensor]) -> None:
        raise NotImplementedError

    def update(self, group: dict, params: list, grads: list, count: int) -> None:
        """Apply the update of step `count` (1 for the first) in place."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = list(group["params"])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if "count" not in self.shared:
            self.init_state(params)
            self.shared["count"] = 0
        self.update(group, params, grads, self.shared["count"] + 1)
        self.shared["count"] += 1
        return loss

    def leaf_states(self, key: str, params: list) -> list[torch.Tensor]:
        return [self.state[p][key] for p in params]


def _zeros(params, key, state) -> None:
    for p in params:
        state[p][key] = torch.zeros_like(p, dtype=torch.float32)


class Adam(TreeOptimizer):
    """optax.adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g² + b2 nu, update
    -lr · mu_hat / (sqrt(nu_hat + eps_root) + eps)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root)

    def init_state(self, params):
        _zeros(params, "mu", self.state)
        _zeros(params, "nu", self.state)

    def update(self, group, params, grads, count):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = self.leaf_states("mu", params), self.leaf_states("nu", params)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        mu_hat = torch._foreach_div(mu, bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, bias_correction(b2, count))
        if group["eps_root"]:
            torch._foreach_add_(nu_hat, group["eps_root"])
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), group["eps"])
        torch._foreach_add_(params, torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                                       -group["lr"]))


class Lion(TreeOptimizer):
    """optax.lion: u = sign((1-b1) g + b1 mu), mu = (1-b2) g + b2 mu, then
    decoupled weight decay and -lr. Defaults as the JAX factory sets them
    (b1 0.9, b2 0.99, weight_decay 0.0)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay)

    def init_state(self, params):
        _zeros(params, "mu", self.state)

    def update(self, group, params, grads, count):
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        mu = self.leaf_states("mu", params)
        u = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(u, torch._foreach_mul(mu, b1))
        torch._foreach_sign_(u)
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b2))
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        torch._foreach_add_(params, torch._foreach_mul(u, -group["lr"]))


class Prodigy(TreeOptimizer):
    """optax.contrib.prodigy (optax 0.2.6), defaults and all: a D-Adapt
    AdamW whose distance estimate `estim_lr` weights recent gradients more.
    `estim_lr` and its sums are reduced over all leaves at once and stay on
    the device."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999),
                 beta3: Optional[float] = None, eps: float = 1e-8, estim_lr0: float = 1e-6,
                 estim_lr_coef: float = 1.0, weight_decay: float = 0.0,
                 safeguard_warmup: bool = False):
        b1, b2 = betas
        super().__init__(params, lr, betas=(b1, b2),
                         beta3=b2**0.5 if beta3 is None else beta3, eps=eps,
                         estim_lr0=estim_lr0, estim_lr_coef=estim_lr_coef,
                         weight_decay=weight_decay, safeguard_warmup=safeguard_warmup)

    def init_state(self, params):
        for key in ("exp_avg", "exp_avg_sq", "grad_sum"):
            _zeros(params, key, self.state)
        for p in params:
            self.state[p]["params0"] = p.detach().float().clone()
        device = params[0].device
        self.shared["estim_lr"] = torch.tensor(self.param_groups[0]["estim_lr0"],
                                               dtype=torch.float32, device=device)
        self.shared["numerator_weighted"] = torch.zeros((), dtype=torch.float32, device=device)

    def update(self, group, params, grads, count):
        (b1, b2), b3 = group["betas"], group["beta3"]
        estim_lr0, wd = group["estim_lr0"], group["weight_decay"]
        shared = self.shared
        estim_lr = shared["estim_lr"]
        bc = float(np.sqrt(np.float32(bias_correction(b2, count)))
                   / np.float32(bias_correction(b1, count)))
        dlr = estim_lr * (group["lr"] * bc)
        dg = torch._foreach_mul(grads, estim_lr)
        param_diff = torch._foreach_sub(self.leaf_states("params0", params), params)
        numerator_acum = tree_dot(grads, param_diff)
        exp_avg = self.leaf_states("exp_avg", params)
        exp_avg_sq = self.leaf_states("exp_avg_sq", params)
        grad_sum = self.leaf_states("grad_sum", params)
        torch._foreach_mul_(exp_avg, b1)
        torch._foreach_add_(exp_avg, torch._foreach_mul(dg, 1.0 - b1))
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_add_(exp_avg_sq, torch._foreach_mul(torch._foreach_mul(dg, dg), 1.0 - b2))
        weight = (estim_lr if group["safeguard_warmup"] else dlr) / estim_lr0
        torch._foreach_mul_(grad_sum, b3)
        torch._foreach_add_(grad_sum, torch._foreach_mul(dg, weight))
        numerator = (b3 * shared["numerator_weighted"]
                     + (estim_lr / estim_lr0) * dlr * numerator_acum)
        lr_estimate = group["estim_lr_coef"] * numerator / tree_l1(grad_sum)
        new_estim_lr = torch.maximum(estim_lr, lr_estimate)
        denom = torch._foreach_add(torch._foreach_sqrt(exp_avg_sq), new_estim_lr * group["eps"])
        step = torch._foreach_div(torch._foreach_mul(exp_avg, dlr), denom)
        if wd:
            torch._foreach_add_(step, torch._foreach_mul(params, wd * dlr))
        torch._foreach_sub_(params, step)
        shared["numerator_weighted"] = numerator
        shared["estim_lr"] = new_estim_lr


class DAdaptAdam(TreeOptimizer):
    """optax.contrib.dadapt_adamw (optax 0.2.6): AdamW whose step size is
    the distance estimate `estim_lr`, from sums over all leaves kept on the
    device."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 estim_lr0: float = 1e-6, weight_decay: float = 0.0):
        b1, b2 = betas
        super().__init__(params, lr, betas=(b1, b2), eps=eps, estim_lr0=estim_lr0,
                         weight_decay=weight_decay)

    def init_state(self, params):
        for key in ("exp_avg", "exp_avg_sq", "grad_sum"):
            _zeros(params, key, self.state)
        device = params[0].device
        self.shared["estim_lr"] = torch.tensor(self.param_groups[0]["estim_lr0"],
                                               dtype=torch.float32, device=device)
        self.shared["numerator_weighted"] = torch.zeros((), dtype=torch.float32, device=device)

    def update(self, group, params, grads, count):
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        sb2 = b2**0.5
        shared = self.shared
        bc = float(np.sqrt(np.float32(bias_correction(b2, count)))
                   / np.float32(bias_correction(b1, count)))
        dlr = shared["estim_lr"] * (group["lr"] * bc)
        exp_avg = self.leaf_states("exp_avg", params)
        exp_avg_sq = self.leaf_states("exp_avg_sq", params)
        grad_sum = self.leaf_states("grad_sum", params)
        s_weighted = torch._foreach_div(
            grad_sum, torch._foreach_add(torch._foreach_sqrt(exp_avg_sq), eps))
        numerator_acum = tree_dot(grads, s_weighted)
        dlr_g = torch._foreach_mul(grads, dlr)
        torch._foreach_mul_(exp_avg, b1)
        torch._foreach_add_(exp_avg, torch._foreach_mul(dlr_g, 1.0 - b1))
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_add_(exp_avg_sq, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                           1.0 - b2))
        torch._foreach_mul_(grad_sum, sb2)
        torch._foreach_add_(grad_sum, torch._foreach_mul(dlr_g, 1.0 - sb2))
        numerator = sb2 * shared["numerator_weighted"] + (1 - sb2) * dlr * numerator_acum
        d_estimate = numerator / ((1 - sb2) * tree_l1(grad_sum))
        step = torch._foreach_div(
            exp_avg, torch._foreach_add(torch._foreach_sqrt(exp_avg_sq), eps))
        if wd:
            torch._foreach_add_(step, torch._foreach_mul(params, wd * dlr))
        torch._foreach_sub_(params, step)
        shared["numerator_weighted"] = numerator
        shared["estim_lr"] = torch.maximum(shared["estim_lr"], d_estimate)


def get_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                  optimizer_args: str = "") -> torch.optim.Optimizer:
    """Name -> torch optimizer over `params` (train_util.py:333-370)."""
    name = name.lower()
    kwargs = parse_optimizer_args(optimizer_args)
    if name == "adamw":
        kwargs.setdefault("eps", 1e-8)
        kwargs.setdefault("weight_decay", 0.01)  # torch AdamW default
        kwargs.setdefault("betas", (0.9, 0.999))
        return torch.optim.AdamW(params, lr=lr, **kwargs)
    # optax's Prodigy and D-Adapt Adam take torch's `betas` as they are
    if name == "prodigy":
        return Prodigy(params, lr, **kwargs)
    if name == "dadaptadam":
        return DAdaptAdam(params, lr, **kwargs)
    kwargs = _map_torch_kwargs(kwargs)
    if name.startswith("dadapt"):
        if name == "dadaptlion":
            from leco_tpu_torch.train.dadapt import DAdaptLion

            return DAdaptLion(params, lr, **kwargs)
        raise ValueError("DAdapt optimizer must be dadaptadam or dadaptlion")
    if name == "adam":
        kwargs.setdefault("eps", 1e-8)
        return Adam(params, lr, **kwargs)
    if name == "adam8bit":
        from leco_tpu_torch.train.quant8 import Adam8bit

        kwargs.setdefault("eps", 1e-8)
        return Adam8bit(params, lr, **kwargs)
    if name == "lion":
        return Lion(params, lr, **kwargs)
    if name == "lion8bit":
        from leco_tpu_torch.train.quant8 import Lion8bit

        return Lion8bit(params, lr, **kwargs)
    raise ValueError("Optimizer must be adam, adamw, lion or Prodigy")
