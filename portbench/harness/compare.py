"""The comparisons that decide ``correct``.

Training: each of the first steps' loss, the first gradient as the
optimizer got it, and the parameters' change over the steps, each of the
last two by its worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero). Leaves whose
reference gradient is under a thousandth of the median leaf's (a key's
bias under softmax) move by round-off alone and are left out, by that
rule and not by name. Beside them, the first step's logits
(``logit_gap_median``): each row's widest gap from the reference, over the
reference's largest logit, the median over the rows. A Mixture of
Experts' routing is a step function: a token whose top experts are a
rounding apart can go to another expert on either side, which moves its
row, that layer's expert and router gradients, and, since Adam turns an
element's near-zero gradient into a whole step of either sign, the worst
leaf and the later steps' losses, from seed to seed as much as computing
in TF32 does (PERF.md, PR 24). The median row holds no such flip, so it
tells the two apart.

Serving: the widest gap between a served probability and the reference's.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

QUIET = 1e-3          # a leaf under this share of the median gradient


@dataclass
class Check:
    name: str
    value: float
    limit: float
    where: str = ""                 # the worst leaf or step, for the log

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Sequence[str]) -> tuple:
    """(the largest gap of norms over the leaves, that leaf's name): each
    leaf's gap over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    p, r = _norms({n: prog[n] for n in leaves}), _norms(
        {n: ref[n] for n in leaves})
    median = statistics.median(r.values())
    gaps = {n: abs(p[n] - r[n]) / max(r[n], median, 1e-30) for n in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(grad_ref)
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= QUIET * median]


def training(prog: dict, ref: dict, params0: Dict[str, torch.Tensor],
             limits: dict) -> List[Check]:
    """``prog`` and ``ref``: {"losses": [...], "logits1": the first step's
    logits, "grad1": {...}, "params": {...}} (the parameters after the
    steps)."""
    leaves = moved_leaves(ref["grad1"])
    steps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
             for a, b in zip(prog["losses"], ref["losses"])]
    worst = max(range(len(steps)), key=steps.__getitem__)
    delta = {n: prog["params"][n] - params0[n] for n in leaves}
    delta_ref = {n: ref["params"][n] - params0[n] for n in leaves}
    grad, grad_at = worst_leaf(prog["grad1"], ref["grad1"], leaves)
    update, update_at = worst_leaf(delta, delta_ref, leaves)
    return [Check("loss_gap", steps[worst], limits["loss_gap"],
                  f"step {worst + 1}"),
            Check("logit_gap_median",
                  median_row_gap(prog["logits1"], ref["logits1"]),
                  limits["logit_gap_median"]),
            Check("grad_gap", grad, limits["grad_gap"], grad_at),
            Check("update_gap", update, limits["update_gap"], update_at)]


def median_row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over rows of each row's widest gap, over the reference's
    largest magnitude (inf where the shapes differ or a value is not
    finite)."""
    if prog.shape != ref.shape or not bool(torch.isfinite(prog).all()):
        return math.inf
    rows = (prog.double() - ref.double()).abs().amax(dim=-1)
    return float(rows.median()) / max(float(ref.abs().max()), 1e-30)


def answers(served: torch.Tensor, ref: torch.Tensor, limit: float,
            name: str = "prob_gap") -> List[Check]:
    """The widest gap between served and reference values (inf where a
    served answer is missing or not finite)."""
    if served.shape != ref.shape or not bool(torch.isfinite(served).all()):
        return [Check(name, math.inf, limit)]
    return [Check(name, float((served.double() - ref.double()).abs().max()),
                  limit)]
