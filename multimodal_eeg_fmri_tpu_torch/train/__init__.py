"""Training of the port: ``make_fit_fn`` / ``fit`` and their train step,
evaluation, the ``Trainer`` class, chunked ``fit_resumable``, the
cross-validation runs (``cv``), the two-stage bridge pipeline
(``bridge_flow``) and hyperparameter search (``hpo``)."""

from multimodal_eeg_fmri_tpu_torch.train.bridge_flow import (
    BridgeResult,
    align_bridge_dataset,
    extract_fused_features,
    run_bridge_loocv,
)
from multimodal_eeg_fmri_tpu_torch.train.cv import (
    CVResult,
    build_fold_arrays,
    eeg_kfold_splits,
    fmri_kfold_splits,
    loocv_splits,
    loso_splits,
    run_cv,
    run_model_suite,
    run_seed_sweep,
    subject_level_votes,
)
from multimodal_eeg_fmri_tpu_torch.train.evaluate import (
    apply_model,
    evaluate_dataset,
    predict_probs,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import (
    RESERVED_KEYS,
    FitCarry,
    FitResult,
    TrainStep,
    fit,
    initial_carry,
    make_fit_fn,
    split_batch,
)
from multimodal_eeg_fmri_tpu_torch.train.hpo import (
    DEFAULT_SPACE,
    HPOResult,
    build_trimodal,
    run_hpo,
    sample_trials,
)
from multimodal_eeg_fmri_tpu_torch.train.resilient import (
    fit_resumable,
    latest_chunk,
)
from multimodal_eeg_fmri_tpu_torch.train.trainer import Trainer

__all__ = [
    "BridgeResult",
    "CVResult",
    "DEFAULT_SPACE",
    "HPOResult",
    "RESERVED_KEYS",
    "FitCarry",
    "FitResult",
    "TrainStep",
    "Trainer",
    "align_bridge_dataset",
    "apply_model",
    "build_fold_arrays",
    "build_trimodal",
    "eeg_kfold_splits",
    "evaluate_dataset",
    "extract_fused_features",
    "fit",
    "fit_resumable",
    "fmri_kfold_splits",
    "initial_carry",
    "latest_chunk",
    "loocv_splits",
    "loso_splits",
    "make_fit_fn",
    "predict_probs",
    "run_bridge_loocv",
    "run_cv",
    "run_hpo",
    "run_model_suite",
    "run_seed_sweep",
    "sample_trials",
    "split_batch",
    "subject_level_votes",
]
