"""Reports of the port: metrics on the device, calibration, conformal
sets, the per-fold clinical report, statistical tests, the exports (CSV,
NPZ, text; ``plots`` holds the matplotlib figures), ensemble uncertainty
and drift monitors."""

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
from multimodal_eeg_fmri_tpu_torch.report.drift import (
    cusum_step,
    ewma_step,
    make_drift_monitor,
)
from multimodal_eeg_fmri_tpu_torch.report.export import (
    export_cv_results,
    export_per_subject_records,
    export_xai_arrays,
    results_dataframe,
    summary_dataframe,
    write_analysis_report,
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
from multimodal_eeg_fmri_tpu_torch.report.uncertainty import (
    ensemble_uncertainty,
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
    "cusum_step",
    "ensemble_uncertainty",
    "evaluate_late_fusion",
    "ewma_step",
    "expected_calibration_error",
    "export_cv_results",
    "export_per_subject_records",
    "export_xai_arrays",
    "fit_temperature",
    "fit_temperature_ensemble",
    "late_fusion_probs",
    "make_drift_monitor",
    "optimal_threshold",
    "paired_tests",
    "pooled_clinical_report",
    "precision_recall_f1",
    "regression_metrics",
    "reliability_curve",
    "results_dataframe",
    "softmax_probs",
    "summary_dataframe",
    "threshold_sweep",
    "write_analysis_report",
]
