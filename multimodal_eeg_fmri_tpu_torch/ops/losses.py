"""Classification and regression losses (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/ops/losses.py``.

Each is a function of (logits, labels[, class_weights]) returning a scalar,
reduced in f32 from an f32 log-softmax. With ``sample_weights`` (padding
rows get 0) every loss is the weighted mean Σ w·l / max(Σ w, 1e-8).
"""

from __future__ import annotations

from typing import Optional

import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def _mean(loss: torch.Tensor, sample_weights: Optional[torch.Tensor]):
    if sample_weights is None:
        return loss.mean()
    w = sample_weights.float()
    return (loss * w).sum() / w.sum().clamp_min(1e-8)


def cross_entropy(logits, labels, sample_weights=None) -> torch.Tensor:
    """Mean CE over the batch; ``labels`` are int class ids."""
    return _mean(_nll(_log_softmax(logits), labels), sample_weights)


def weighted_cross_entropy(logits, labels, class_weights,
                           sample_weights=None) -> torch.Tensor:
    """CE with per-class weights, normalised by the summed weights of the
    rows (torch ``CrossEntropyLoss(weight=...)`` semantics)."""
    nll = _nll(_log_softmax(logits), labels)
    w = class_weights.float()[labels.long()]
    if sample_weights is not None:
        w = w * sample_weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1e-8)


def focal_loss(logits, labels, alpha: float = 0.25, gamma: float = 2.0,
               sample_weights=None) -> torch.Tensor:
    """``alpha · (1 − p_t)^gamma · CE``."""
    nll = _nll(_log_softmax(logits), labels)
    pt = torch.exp(-nll)
    return _mean(alpha * (1.0 - pt) ** gamma * nll, sample_weights)


def label_smoothing_cross_entropy(logits, labels, smoothing: float = 0.1,
                                  sample_weights=None) -> torch.Tensor:
    """``(1 − ε)·NLL + ε·mean(−logp)``, the reference's formulation."""
    logp = _log_softmax(logits)
    loss = ((1.0 - smoothing) * _nll(logp, labels)
            + smoothing * -logp.mean(dim=-1))
    return _mean(loss, sample_weights)


def mse_loss(preds, targets, sample_weights=None) -> torch.Tensor:
    return _mean((preds.float() - targets.float()) ** 2, sample_weights)


def make_loss_fn(name: str, **kw):
    """Resolve a ``TrainConfig.loss`` name to a callable
    ``loss(logits, labels, class_weights, sample_weights)``."""
    if name == "ce":
        return lambda lo, la, cw=None, sw=None: cross_entropy(lo, la, sw)
    if name == "weighted_ce":
        def _wce(lo, la, cw=None, sw=None):
            if cw is None:
                return cross_entropy(lo, la, sw)
            return weighted_cross_entropy(lo, la, cw, sw)
        return _wce
    if name == "focal":
        a, g = kw.get("alpha", 0.25), kw.get("gamma", 2.0)
        return lambda lo, la, cw=None, sw=None: focal_loss(lo, la, a, g, sw)
    if name == "label_smoothing":
        s = kw.get("smoothing", 0.1)
        return lambda lo, la, cw=None, sw=None: label_smoothing_cross_entropy(
            lo, la, s, sw)
    if name == "mse":
        return lambda lo, la, cw=None, sw=None: mse_loss(lo, la, sw)
    raise ValueError(f"unknown loss {name!r}")
