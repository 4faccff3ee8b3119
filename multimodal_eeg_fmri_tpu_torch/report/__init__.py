"""Evaluation metrics of the port, computed on the device."""

from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    accuracy,
    auc_roc,
    binary_classification_metrics,
    precision_recall_f1,
    regression_metrics,
    softmax_probs,
)

__all__ = [
    "accuracy",
    "auc_roc",
    "binary_classification_metrics",
    "precision_recall_f1",
    "regression_metrics",
    "softmax_probs",
]
