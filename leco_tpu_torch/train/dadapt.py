"""D-Adaptation Lion.

Counterpart of `leco_tpu/train/dadapt.py` (the reference maps
"dadaptlion" to `dadaptation.DAdaptLion`, train_util.py:336-344): the
published algorithm (Defazio & Mishchenko, ICML 2023, the Lion variant of
the dadaptation repository) as the JAX package writes it. Per step, with
dlr = d * lr(t), sqb2 = sqrt(b2):

    u   = sign(b1 * m + (1 - b1) * dlr * g)
    p  -= dlr * u  (+ decoupled weight decay dlr * wd * p)
    m   = b2 * m + (1 - b2) * dlr * g
    num = sqb2 * num + (1 - sqb2) * dlr * <u, s>    (s of the previous step)
    s   = sqb2 * s + (1 - sqb2) * dlr * u
    d   = max(d, num / ((1 - sqb2) * ||s||_1))

d starts at d0 = 1e-6 and only grows. d, num and the two tree sums are 0-d
device tensors: the step never waits for the device.
"""

from __future__ import annotations

import torch

from leco_tpu_torch.train.optim import TreeOptimizer, tree_dot, tree_l1


class DAdaptLion(TreeOptimizer):
    def __init__(self, params, lr: float = 1.0, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0, d0: float = 1e-6):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay, d0=d0)

    def init_state(self, params):
        for p in params:
            self.state[p]["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            self.state[p]["s"] = torch.zeros_like(p, dtype=torch.float32)
        device = params[0].device
        self.shared["d"] = torch.tensor(self.param_groups[0]["d0"], dtype=torch.float32,
                                        device=device)
        self.shared["numerator"] = torch.zeros((), dtype=torch.float32, device=device)

    def update(self, group, params, grads, count):
        b1, b2, wd, lr = group["b1"], group["b2"], group["weight_decay"], group["lr"]
        sqb2 = b2**0.5
        shared = self.shared
        d = shared["d"]
        dlr = d * lr
        exp_avg, s = self.leaf_states("exp_avg", params), self.leaf_states("s", params)
        # both terms on the dlr scale (exp_avg is dlr-scaled)
        u = torch._foreach_mul(exp_avg, b1)
        torch._foreach_add_(u, torch._foreach_mul(grads, (1.0 - b1) * dlr))
        torch._foreach_sign_(u)
        numerator_acc = dlr * tree_dot(u, s)  # s of the previous step
        torch._foreach_mul_(exp_avg, b2)
        torch._foreach_add_(exp_avg, torch._foreach_mul(grads, (1.0 - b2) * dlr))
        torch._foreach_mul_(s, sqb2)
        torch._foreach_add_(s, torch._foreach_mul(u, (1.0 - sqb2) * dlr))
        numerator = sqb2 * shared["numerator"] + (1.0 - sqb2) * numerator_acc
        sk_l1 = tree_l1(s)
        d_hat = numerator / ((1.0 - sqb2) * torch.clamp_min(sk_l1, 1e-30))
        if lr > 0.0:
            shared["d"] = torch.where(sk_l1 > 0.0, torch.maximum(d, d_hat), d)
        shared["numerator"] = numerator
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        torch._foreach_sub_(params, torch._foreach_mul(u, dlr))
