"""Split-conformal prediction sets (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/report/conformal.py``.

Split conformal (Vovk et al.; Angelopoulos & Bates 2023 tutorial form):
hold out a calibration fold, compute a nonconformity score per example,
take the ⌈(n+1)(1−α)⌉/n empirical quantile q̂, and at test time include
every class whose score ≤ q̂. Two standard scores:

- ``lac``  (Least Ambiguous set-valued Classifier): score = 1 − p_y.
- ``aps``  (Adaptive Prediction Sets): score = cumulative probability mass
  of classes ranked above y, plus y's own mass (deterministic variant).

Tensors or arrays in, tensors out, on the inputs' device (the card for an
array, as in ``calibration.py``); the quantile rank
is computed in f32, as the JAX package computes it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_eeg_fmri_tpu_torch.report.calibration import _t, _w


def _scores(probs: torch.Tensor, labels: torch.Tensor,
            method: str) -> torch.Tensor:
    """Per-example nonconformity score of the TRUE class."""
    p_true = probs.gather(-1, labels[:, None])[:, 0]
    if method == "lac":
        return 1.0 - p_true
    if method == "aps":
        # mass of classes with prob strictly above the true class + own mass
        above = torch.where(probs > p_true[:, None], probs, 0.0).sum(-1)
        return above + p_true
    raise ValueError(f"unknown method {method!r} (use 'lac' or 'aps')")


def conformal_calibrate(
    probs_cal,                     # (n, C) calibration-fold probabilities
    labels_cal,                    # (n,)
    alpha: float = 0.1,            # 1 - target coverage
    method: str = "lac",
    weights=None,
) -> torch.Tensor:
    """q̂: the ⌈(n+1)(1−α)⌉/n empirical quantile of calibration scores.

    ``weights`` is the 0/1 padding mask (padded rows must not count toward
    n): masked rows get score −inf so they sort first and the quantile
    index is computed from the REAL row count. An all-masked calibration
    set gives q̂ = +inf (full sets), not empty ones.
    """
    probs_cal = _t(probs_cal).float()
    labels_cal = _t(labels_cal, device=probs_cal.device).long()
    w = _w(weights, probs_cal.shape[0], probs_cal.device)
    scores = _scores(probs_cal, labels_cal, method)
    scores = torch.where(w > 0, scores, -torch.inf)
    n_real = (w > 0).sum()
    level = torch.tensor(1.0 - alpha, dtype=torch.float32,
                         device=probs_cal.device)
    rank = torch.minimum(torch.ceil((n_real + 1).float() * level).long(),
                         n_real)
    sorted_scores = torch.sort(scores).values
    pad = scores.shape[0] - n_real          # number of −inf entries in front
    qhat = sorted_scores[pad + rank - 1]
    return torch.where(n_real > 0, qhat, torch.inf)


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the last (class) axis, one f32 addition at a time,
    as the JAX package sums it: ``torch.cumsum`` on the CPU accumulates
    floats in double, which moves a set's edge where a sum meets q̂."""
    out = [x[..., 0]]
    for c in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., c])
    return torch.stack(out, dim=-1)


def conformal_sets(probs, qhat, method: str = "lac") -> torch.Tensor:
    """Boolean membership (m, C): class c is in the set iff its score ≤ q̂."""
    probs = _t(probs).float()
    qhat = _t(qhat, device=probs.device)
    if method == "lac":
        return (1.0 - probs) <= qhat
    if method == "aps":
        order = torch.argsort(-probs, dim=-1, stable=True)
        cum = _cumsum_f32(probs.gather(-1, order))
        keep_sorted = cum <= qhat
        # always include the top class (cum[0] may already exceed q̂)
        keep_sorted[:, 0] = True
        inv = torch.argsort(order, dim=-1, stable=True)
        return keep_sorted.gather(-1, inv)
    raise ValueError(f"unknown method {method!r} (use 'lac' or 'aps')")


def coverage_and_size(sets, labels, weights=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(empirical coverage, average set size) under the padding mask."""
    sets = _t(sets)
    labels = _t(labels, device=sets.device).long()
    w = _w(weights, sets.shape[0], sets.device)
    wsum = w.sum().clamp_min(1e-8)
    hit = sets.gather(-1, labels[:, None])[:, 0]
    cov = (w * hit).sum() / wsum
    size = (w * sets.sum(-1)).sum() / wsum
    return cov, size
