"""The comparison that decides `correct`: the numbers compared with the
reference, and each number against its limit.  The cell's limits file
names the numbers it holds; the others are printed beside them.

Training (the first steps of the window's own captured step).  Each side
gives each step's loss, the first gradient as the optimizer got it, and
each leaf's change over the steps.  A leaf's gap is |norm - reference
norm| over the larger of its reference norm and the median leaf's;
"moved" leaves are those whose reference gradient is at least `MOVED`
of the median leaf's (a leaf below that moves under AdamW by round-off
alone):

* loss1_gap, loss_gap: |loss - reference| / |reference| of the first
  step, and the largest over the steps;
* head_grad_err: the norm of the difference from the reference's first
  gradient over the reference's norm, over the leaves of the model's
  last layer (the head, which reads the whole forward and no deformable
  op's backward);
* grad_median_gap, grad_gap: the first gradient's gap, the median leaf
  and the worst leaf;
* delta_median_gap, delta_gap: the change's gap over the moved leaves,
  the median leaf and the worst leaf.

Why these (PERF.md §2): a deformable op's sampling derivative jumps where
a sample crosses an integer, so TF32's round-off moves the gradient of
every leaf upstream of one by a few percent; the median leaf's gap stays
steady while a wrong backward of the op moves it tenfold, the head's
error follows the forward's arithmetic, and a leaf the program leaves
unmoved reads a worst-leaf change gap of 1.

Serving: logit_gap, the largest max|logits - reference| / max|reference|
over every compared request.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

MOVED = 1e-3
TRAIN_NUMBERS = ("loss1_gap", "loss_gap", "head_grad_err",
                 "grad_median_gap", "grad_gap", "delta_median_gap",
                 "delta_gap")


def _worst(values) -> float:
    """The largest value; inf where any is not finite (a NaN would hide
    in max())."""
    values = list(values)
    return (max(values) if values and all(map(math.isfinite, values))
            else math.inf)


def _median(values) -> float:
    values = list(values)
    return (statistics.median(values)
            if values and all(map(math.isfinite, values)) else math.inf)


def _leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keys: Sequence[str]) -> Dict[str, float]:
    """Per leaf: |norm - reference norm| over max(reference norm, the
    median leaf's reference norm)."""
    n_ref = {k: float(ref[k].double().norm()) for k in keys}
    floor = statistics.median(n_ref.values())
    return {k: abs(float(got[k].double().norm()) - n_ref[k])
            / max(n_ref[k], floor, 1e-30) for k in keys}


def head(keys: Sequence[str]) -> list:
    """The leaves of the model's last layer: those that share the module
    path of the last leaf in the parameter list, which runs in forward
    order (`fc.weight`, `fc.bias`)."""
    last = keys[-1].rsplit(".", 1)[0] + "."
    return [k for k in keys if k.startswith(last)]


def _err(got, ref, keys) -> float:
    diff = sum(float((got[k].double().to(ref[k].device) - ref[k].double())
                     .pow(2).sum()) for k in keys)
    norm = sum(float(ref[k].double().pow(2).sum()) for k in keys)
    return math.sqrt(diff / max(norm, 1e-300))


def train_numbers(prog: dict, ref: dict, detail: bool = False) -> dict:
    """prog and ref: {"losses": [...], "grad": {leaf: tensor}, "delta":
    {leaf: tensor}}, the leaves in the parameter list's order.  Where the
    sides hold different leaves or steps, every number reads inf.
    `detail` adds the leaves' count, each step's loss gap and the leaf
    that sets each worst-leaf number."""
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["losses"]) != len(
            ref["losses"]):
        return dict.fromkeys(TRAIN_NUMBERS, math.inf)
    loss = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    keys = list(ref["grad"])
    g_norm = {k: float(ref["grad"][k].double().norm()) for k in keys}
    floor = statistics.median(g_norm.values())
    moved = [k for k in keys if g_norm[k] >= MOVED * floor]
    out = {"loss1_gap": _worst(loss[:1]), "loss_gap": _worst(loss)}
    err = _err(prog["grad"], ref["grad"], head(keys))
    out["head_grad_err"] = err if math.isfinite(err) else math.inf
    gaps = _leaf_gaps(prog["grad"], ref["grad"], keys)
    out["grad_median_gap"] = _median(gaps.values())
    out["grad_gap"] = _worst(gaps.values())
    d_gaps = _leaf_gaps(prog["delta"], ref["delta"], moved)
    out["delta_median_gap"] = _median(d_gaps.values())
    out["delta_gap"] = _worst(d_gaps.values())
    if detail:
        out["leaves"] = {"all": len(keys), "moved": len(moved),
                         "head": len(head(keys))}
        out["loss_gaps"] = loss
        out["leaves_at"] = {"grad_gap": max(gaps, key=gaps.get),
                            "delta_gap": max(d_gaps, key=d_gaps.get)}
    return out


def leaf_table(prog: dict, ref: dict) -> dict:
    """Per leaf, for a look at the readings: the norms of the reference's
    and the program's first gradient and of their difference, and the
    same of the change over the steps."""
    out = {}
    for k in ref["grad"]:
        row = []
        for part in ("grad", "delta"):
            a = prog[part][k].double().to(ref[part][k].device)
            b = ref[part][k].double()
            row += [float(b.norm()), float(a.norm()), float((a - b).norm())]
        out[k] = row
    return out


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref| of one request's logits."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number the limits name finite and at most
    its limit; the checks {name: {"value", "limit"}} in the limits'
    order."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
