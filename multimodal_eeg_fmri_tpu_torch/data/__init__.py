"""Data of the port: dataset helpers (numpy), the raw-EEG featurizer
(``raw``), NIfTI I/O and the fMRI ROI pipeline (``nifti``), and the
streaming featurizer (``streaming``)."""

from multimodal_eeg_fmri_tpu_torch.data.arrays import (
    balanced_class_weights,
    pad_rows,
    subset,
    validate_dataset,
)
from multimodal_eeg_fmri_tpu_torch.data.streaming import (
    make_streaming_featurizer,
    stream_session,
)

__all__ = [
    "balanced_class_weights",
    "make_streaming_featurizer",
    "pad_rows",
    "stream_session",
    "subset",
    "validate_dataset",
]
