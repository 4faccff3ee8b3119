"""Training of the port: ``make_fit_fn`` / ``fit`` and their train step,
evaluation, the ``Trainer`` class and chunked ``fit_resumable``."""

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
    "RESERVED_KEYS",
    "FitCarry",
    "FitResult",
    "TrainStep",
    "Trainer",
    "apply_model",
    "evaluate_dataset",
    "fit",
    "fit_resumable",
    "initial_carry",
    "latest_chunk",
    "make_fit_fn",
    "predict_probs",
    "split_batch",
]
