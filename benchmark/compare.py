"""The numbers that decide `correct`, each against its limit.

A side's record (`reference.train.Followed`) of its first steps is held
against the reference's:

  loss_gap    the largest over the steps of |loss - loss_ref| / |loss_ref|;
  grad_gap    the first step's gradient, as the optimizer got it, by its
              worst leaf: |norm - norm_ref| / max(norm_ref, the median
              leaf's norm_ref);
  change_gap  the LoRA's change over the steps, by its worst leaf, in the
              same measure. Leaves whose reference gradient stays under a
              thousandth of the median leaf's at every step move by
              round-off alone and are left out;
  change_median_gap  the median over those leaves of the same per-leaf gap
              of the change: steady where one leaf's rounding swings.

The runner reads them twice: over the set-up's first steps from the seed,
and (`late.<name>`) over the pair after the window from a copy of the
program's state. A cell's limits file names the numbers that decide its
`correct`.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
import statistics

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median leaf's


def _worst_leaf(side: dict, ref: dict, leaves) -> tuple:
    """(the worst leaf's gap, that leaf, its reference norm, the median
    leaf's reference norm, its norm on `side`)."""
    norms = {k: float(ref[k].norm()) for k in leaves}
    floor = statistics.median(norms.values())
    worst = (0.0, "", 0.0, floor, 0.0)
    for k in leaves:
        denom = max(norms[k], floor)
        gap = abs(float(side[k].norm()) - norms[k])
        if denom == 0.0:
            gap, denom = (0.0, 1.0) if gap == 0.0 else (math.inf, 1.0)
        value = gap / denom if math.isfinite(gap) else math.inf
        if not value <= worst[0]:
            worst = (value, k, norms[k], floor, float(side[k].norm()))
    return worst


def moving_leaves(ref) -> list:
    """The leaves whose reference gradient is not negligible at some step."""
    peak = {k: max(step[k] for step in ref.grad_norms) for k in ref.grad_norms[0]}
    floor = statistics.median(peak.values())
    return sorted(k for k, v in peak.items() if v >= NEGLIGIBLE * floor)


def readings(side, ref, initial: dict) -> tuple[dict, dict]:
    """({name: value}, {name: where the worst of it lies}) of `side`
    against the reference `ref`, both from the LoRA tree `initial`."""
    gaps = [abs(a - b) / abs(b) if b else math.inf for a, b in zip(side.losses, ref.losses)]
    gaps = [g if math.isfinite(g) else math.inf for g in gaps]
    leaves = sorted(ref.first_grad)
    grad = _worst_leaf(side.first_grad, ref.first_grad, leaves)
    moved = moving_leaves(ref)
    side_change = {k: side.params[k].float() - initial[k].float() for k in moved}
    ref_change = {k: ref.params[k].float() - initial[k].float() for k in moved}
    change = _worst_leaf(side_change, ref_change, moved)
    by_leaf = sorted(((abs(float(side_change[k].norm()) - float(ref_change[k].norm()))
                       / max(float(ref_change[k].norm()), change[3]), k) for k in moved),
                     reverse=True)
    values = {"loss_gap": max(gaps), "grad_gap": grad[0], "change_gap": change[0],
              "change_median_gap": statistics.median(g for g, _ in by_leaf)}
    peak = {k: max(step[k] for step in ref.grad_norms) for k in leaves}
    median_peak = statistics.median(peak.values())
    keys = ("leaf", "ref_norm", "median_leaf", "side_norm")
    where = {"loss_gap": {"step": gaps.index(max(gaps)) + 1, "gaps": gaps},
             "grad_gap": dict(zip(keys, grad[1:])),
             "change_gap": dict(zip(keys, change[1:]), left_out=len(leaves) - len(moved)),
             # the worst leaves of the change, each with its peak gradient
             # over the median leaf's
             "change_top": [[round(g, 5), k, peak[k] / median_peak] for g, k in by_leaf[:6]]}
    return values, where


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
