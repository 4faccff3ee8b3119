"""Training of the port: ``make_fit_fn`` / ``fit`` and their train step,
evaluation, the ``Trainer`` class, chunked ``fit_resumable`` and the
cross-validation runs (``cv``)."""

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
from multimodal_eeg_fmri_tpu_torch.train.resilient import (
    fit_resumable,
    latest_chunk,
)
from multimodal_eeg_fmri_tpu_torch.train.trainer import Trainer

__all__ = [
    "CVResult",
    "RESERVED_KEYS",
    "FitCarry",
    "FitResult",
    "TrainStep",
    "Trainer",
    "apply_model",
    "build_fold_arrays",
    "eeg_kfold_splits",
    "evaluate_dataset",
    "fit",
    "fit_resumable",
    "fmri_kfold_splits",
    "initial_carry",
    "latest_chunk",
    "loocv_splits",
    "loso_splits",
    "make_fit_fn",
    "predict_probs",
    "run_cv",
    "run_model_suite",
    "run_seed_sweep",
    "split_batch",
    "subject_level_votes",
]
