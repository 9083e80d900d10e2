"""The comparison that decides `correct`: numbers computed from the
program's outputs and the reference's, each held to the limit that the
traffic mix's `limits` give it. A traffic loop (`loops/<name>.py`) picks
the numbers it compares; these are the view and training loops'.

View cells compare frames: `frame_max_abs`, the largest absolute gap of a
pixel channel over the sampled frames, and `frame_mean_abs`, the largest
over those frames of the mean absolute gap.

Training cells compare the first steps: `loss_rel`, the largest relative
gap of a step's loss; `grad_norm_gap`, the largest over leaves of the gap
between the program's and the reference's norm of the first gradient;
`change_norm_gap`, the same for the norm of each leaf's change over the
steps. A leaf's gap is taken against the larger of the reference's norm of
that leaf and the median leaf's. A leaf whose reference gradient norm is
under a thousandth of the median leaf's is left out of both: Adam moves
such a leaf by round-off alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

QUIET_LEAF = 1e-3


def view_numbers(program: List[torch.Tensor],
                 reference: List[torch.Tensor]) -> Dict[str, float]:
    worst_max = worst_mean = 0.0
    for p, r in zip(program, reference):
        p, r = p.detach().float().cpu(), r.detach().float().cpu()
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            return {"frame_max_abs": math.inf, "frame_mean_abs": math.inf}
        d = (p - r).abs()
        worst_max = max(worst_max, float(d.max()))
        worst_mean = max(worst_mean, float(d.mean()))
    return {"frame_max_abs": worst_max, "frame_mean_abs": worst_mean}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              counted) -> float:
    med = statistics.median(ref[k] for k in counted)
    gap = 0.0
    for k in counted:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        gap = max(gap, g if math.isfinite(g) else math.inf)
    return gap


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """`program` and `reference` hold "loss" [steps], "grad_norm" and
    "change_norm" {leaf: norm}."""
    loss_rel = 0.0
    for lp, lr in zip(program["loss"], reference["loss"]):
        g = abs(lp - lr) / abs(lr)
        loss_rel = max(loss_rel, g if math.isfinite(g) else math.inf)
    ref_g = reference["grad_norm"]
    med = statistics.median(ref_g.values())
    counted = [k for k, v in ref_g.items() if v >= QUIET_LEAF * med]
    return {"loss_rel": loss_rel,
            "grad_norm_gap": _leaf_gap(program["grad_norm"], ref_g, counted),
            "change_norm_gap": _leaf_gap(program["change_norm"],
                                         reference["change_norm"], counted)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """→ (correct, {name: {"value", "limit"}}): correct when every number
    is finite and at most its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
