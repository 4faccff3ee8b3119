"""Whole-dataset evaluation (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/train/evaluate.py``: one forward over the eval set
on the model's device returns the full ``ModelOutput`` and the metric dict.

``params`` and ``batch_stats`` are dicts by state-dict name, as in
``FitResult.params`` and ``.batch_stats``; they stand in for the module's
own for the call and leave the module's weights untouched. None uses the
module's own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    binary_classification_metrics,
    regression_metrics,
    softmax_probs,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import (
    _apply_eval,
    _to_device,
    split_batch,
)

Weights = Optional[Dict[str, torch.Tensor]]


def apply_model(model: nn.Module, params: Weights, batch_stats: Weights,
                data: Dict[str, Any], train: bool = False,
                program: Optional[Callable] = None):
    """The forward of ``model`` with the given params and statistics. In
    train mode BatchNorm normalises with the batch's statistics and updates
    a copy of the running ones; dropout draws from the device's default
    generator. No autograd. ``program`` (eval mode only) runs the forward in
    the module's place, as in ``train.fit._apply_eval``."""
    dev = next(model.parameters()).device
    inputs = split_batch(_to_device(data, dev))
    stats = dict(model.named_buffers()) if batch_stats is None else batch_stats
    if train:  # BatchNorm updates its running statistics in place
        stats = {k: v.clone() for k, v in stats.items()}
    tensors = {**(params or {}), **stats}
    was_training = model.training
    try:
        if not train:
            return _apply_eval(model, inputs, tensors, program)
        model.train()
        with torch.no_grad():
            return functional_call(model, tensors, (), inputs)
    finally:
        model.train(was_training)


def evaluate_dataset(model: nn.Module, params: Weights, batch_stats: Weights,
                     data: Dict[str, Any], task: str = "classification",
                     program: Optional[Callable] = None
                     ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(metric dict, ModelOutput) for a whole dataset in one eval pass
    (through ``program``, as ``apply_model``'s, where given)."""
    data = _to_device(data, next(model.parameters()).device)
    out = apply_model(model, params, batch_stats, data, program=program)
    metric_fn = (regression_metrics if task == "regression"
                 else binary_classification_metrics)
    return metric_fn(out.logits, data["label"], data.get("weight")), out


def predict_probs(model: nn.Module, params: Weights, batch_stats: Weights,
                  data: Dict[str, Any]) -> torch.Tensor:
    _, out = evaluate_dataset(model, params, batch_stats, data)
    return softmax_probs(out.logits)
