"""Reports of the port: metrics on the device, calibration, conformal
sets, the per-fold clinical report and statistical tests."""

from multimodal_eeg_fmri_tpu_torch.report.calibration import (
    brier_score,
    expected_calibration_error,
    fit_temperature,
    fit_temperature_ensemble,
    optimal_threshold,
    reliability_curve,
    threshold_sweep,
)
from multimodal_eeg_fmri_tpu_torch.report.clinical import (
    clinical_report,
    pooled_clinical_report,
)
from multimodal_eeg_fmri_tpu_torch.report.conformal import (
    conformal_calibrate,
    conformal_sets,
    coverage_and_size,
)
from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    accuracy,
    auc_roc,
    binary_classification_metrics,
    precision_recall_f1,
    regression_metrics,
    softmax_probs,
)
from multimodal_eeg_fmri_tpu_torch.report.stats import (
    compare_models,
    confidence_interval,
    evaluate_late_fusion,
    late_fusion_probs,
    paired_tests,
)

__all__ = [
    "accuracy",
    "auc_roc",
    "binary_classification_metrics",
    "brier_score",
    "clinical_report",
    "compare_models",
    "confidence_interval",
    "conformal_calibrate",
    "conformal_sets",
    "coverage_and_size",
    "evaluate_late_fusion",
    "expected_calibration_error",
    "fit_temperature",
    "fit_temperature_ensemble",
    "late_fusion_probs",
    "optimal_threshold",
    "paired_tests",
    "pooled_clinical_report",
    "precision_recall_f1",
    "regression_metrics",
    "reliability_curve",
    "softmax_probs",
    "threshold_sweep",
]
