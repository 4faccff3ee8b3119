"""Evaluation metrics on the device (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/report/metrics.py``: the reference's sklearn
metrics as tensor functions, so that per-epoch model selection reads no value
back to the host. Every function takes an optional ``weights`` mask, so that
padding rows drop out. AUC is the Mann-Whitney statistic with ties counted
one half, which equals ``sklearn.metrics.roc_auc_score``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _w(weights: Optional[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
    if weights is None:
        return torch.ones(labels.shape[0], dtype=torch.float32,
                          device=labels.device)
    return weights.float()


def accuracy(preds, labels, weights=None) -> torch.Tensor:
    w = _w(weights, labels)
    return ((preds == labels) * w).sum() / w.sum().clamp_min(1e-8)


def _binary_counts(preds, labels, w):
    tp = ((preds == 1) * (labels == 1) * w).sum()
    fp = ((preds == 1) * (labels == 0) * w).sum()
    fn = ((preds == 0) * (labels == 1) * w).sum()
    tn = ((preds == 0) * (labels == 0) * w).sum()
    return tp, fp, fn, tn


def precision_recall_f1(preds, labels, weights=None):
    """Binary precision, recall and F1 of the positive class (sklearn
    ``average='binary'``)."""
    tp, fp, fn, _ = _binary_counts(preds, labels, _w(weights, labels))
    precision = tp / (tp + fp).clamp_min(1e-8)
    recall = tp / (tp + fn).clamp_min(1e-8)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-8)
    return precision, recall, f1


def auc_roc(scores, labels, weights=None) -> torch.Tensor:
    """ROC AUC = P(score_pos > score_neg) + ½·P(score_pos == score_neg),
    a weighted pairwise comparison (O(n²), exact with weights)."""
    w = _w(weights, labels)
    s = scores.float()
    lt = (s[None, :] < s[:, None]).float()  # [i, j] = s_j < s_i
    eq = (s[None, :] == s[:, None]).float()
    wn = w * (labels == 0)
    wp = w * (labels == 1)
    contrib = lt @ wn + 0.5 * (eq @ wn)
    u = (contrib * wp).sum()
    return u / (wp.sum() * wn.sum()).clamp_min(1e-8)


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def binary_classification_metrics(logits, labels, weights=None
                                  ) -> Dict[str, torch.Tensor]:
    """accuracy, f1, precision, recall, specificity and auc (class-1
    probability scores)."""
    preds = logits.argmax(dim=-1)
    p, r, f1 = precision_recall_f1(preds, labels, weights)
    _, fp, _, tn = _binary_counts(preds, labels, _w(weights, labels))
    return {
        "accuracy": accuracy(preds, labels, weights),
        "f1": f1,
        "precision": p,
        "recall": r,
        "specificity": tn / (tn + fp).clamp_min(1e-8),
        "auc": auc_roc(softmax_probs(logits)[:, 1], labels, weights),
    }


def regression_metrics(preds, targets, weights=None
                       ) -> Dict[str, torch.Tensor]:
    """MSE, RMSE, MAE and R²."""
    w = _w(weights, targets)
    wsum = w.sum().clamp_min(1e-8)
    p, t = preds.float(), targets.float()
    mse = (w * (p - t) ** 2).sum() / wsum
    mae = (w * (p - t).abs()).sum() / wsum
    tmean = (w * t).sum() / wsum
    ss_tot = (w * (t - tmean) ** 2).sum()
    r2 = 1.0 - (w * (p - t) ** 2).sum() / ss_tot.clamp_min(1e-8)
    return {"mse": mse, "rmse": mse.sqrt(), "mae": mae, "r2": r2}
