"""The numbers that decide ``correct``, each against its limit.

Training: the program's first steps against the reference's, from the same
parameters, batches and draws. ``loss_gap``, the worst step's relative gap
of the loss; then, per leaf, the gap between the program's norm and the
reference's over the reference's norm of that leaf or of the median leaf,
whichever is larger, worst leaf: ``grad_gap`` of the first gradient as the
optimizer takes it (the momentum after one step), ``param_gap`` of the
parameters' change over the steps, ``bnstat_gap`` of the moving statistics'
change, ``ema_gap`` of the EMA's change. Leaves whose reference gradient is
below a thousandth of the median leaf's move by rounding alone and are
left out of the changes.

Serving: every answer due in the window against the reference's logits of
its image, as a relative L2 distance: ``logit_rel_l2``, the worst answer's,
and ``logit_rel_l2_median``, the median answer's. An answer that never
came reads infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RULE = 1e-3  # a leaf moves by rounding alone below this share of the median leaf's gradient


def worst(values) -> float:
    """The largest value, a NaN reading as infinite."""
    return max(v if v == v else math.inf for v in values)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> list:
    med = float(np.median(list(ref.values())))
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in ref), reverse=True)
    return [[k, g, ref[k] / med] for g, k in gaps[:top]]


def moving_leaves(grads: dict) -> set:
    med = float(np.median(list(grads.values())))
    return {k for k, v in grads.items() if v >= RULE * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` [per step], ``grad``,
    ``param``, ``bnstat`` and ``ema`` ({leaf: norm}; ``ema`` may be empty)."""
    keep = moving_leaves(ref["grad"])
    out = {"loss_gap": worst(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           "param_gap": leaf_gap(prog["param"], ref["param"], keep),
           "bnstat_gap": leaf_gap(prog["bnstat"], ref["bnstat"])}
    if ref["ema"]:
        out["ema_gap"] = leaf_gap(prog["ema"], ref["ema"], keep)
    return out


def serve_numbers(answers: torch.Tensor, answered: torch.Tensor, images: torch.Tensor,
                  ref_logits: torch.Tensor, block: int = 8192) -> dict:
    """``answers`` (R, classes) fp32 on the host, ``answered`` (R,) bool,
    ``images`` (R,) pool index of each request, ``ref_logits`` (pool,
    classes) fp32 on the judging device."""
    missing = {"logit_rel_l2": math.inf, "logit_rel_l2_median": math.inf}
    if not bool(answered.all()):
        return missing
    rels = []
    for i in range(0, answers.shape[0], block):
        a = answers[i:i + block].to(ref_logits.device, torch.float32)
        r = ref_logits[images[i:i + block].to(ref_logits.device)]
        if not bool(torch.isfinite(a).all()):
            return missing
        rels.append(((a - r).norm(dim=1) / r.norm(dim=1)).cpu())
    rels = torch.cat(rels)
    return {"logit_rel_l2": float(rels.max()), "logit_rel_l2_median": float(rels.median())}


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}


def is_correct(checked: dict) -> bool:
    return bool(checked) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                 for c in checked.values())
