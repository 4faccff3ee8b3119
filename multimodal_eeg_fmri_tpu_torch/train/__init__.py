"""Training of the port: ``make_fit_fn`` / ``fit`` and their train step."""

from multimodal_eeg_fmri_tpu_torch.train.fit import (
    RESERVED_KEYS,
    FitResult,
    TrainStep,
    fit,
    make_fit_fn,
    split_batch,
)

__all__ = [
    "RESERVED_KEYS",
    "FitResult",
    "TrainStep",
    "fit",
    "make_fit_fn",
    "split_batch",
]
