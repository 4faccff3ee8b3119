"""Data of the port: dataset helpers (numpy), cross-validation splits
(``splits``) and per-fold normalization (``normalize``), synthetic cohorts
(``synthetic``), the raw-EEG featurizer (``raw``), NIfTI I/O and the fMRI
ROI pipeline (``nifti``), the streaming featurizer (``streaming``), the
reference's file readers (``loaders``, over the native ingest in
``native_io``) and the subject joiners (``handler``)."""

from multimodal_eeg_fmri_tpu_torch.data.arrays import (
    balanced_class_weights,
    pad_and_stack,
    pad_rows,
    stack_trees,
    subset,
    train_val_split,
    validate_dataset,
)
from multimodal_eeg_fmri_tpu_torch.data.normalize import (
    FoldNormalizer,
    feature_standardize,
)
from multimodal_eeg_fmri_tpu_torch.data.splits import (
    Split,
    leave_one_out,
    leave_one_subject_out,
    stratified_group_kfold,
    stratified_kfold,
)
from multimodal_eeg_fmri_tpu_torch.data.streaming import (
    make_streaming_featurizer,
    stream_session,
)
from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
    synthetic_bridge,
    synthetic_eeg_trimodal,
    synthetic_fmri,
)

__all__ = [
    "FoldNormalizer",
    "Split",
    "balanced_class_weights",
    "feature_standardize",
    "leave_one_out",
    "leave_one_subject_out",
    "make_streaming_featurizer",
    "pad_and_stack",
    "pad_rows",
    "stack_trees",
    "stratified_group_kfold",
    "stratified_kfold",
    "stream_session",
    "subset",
    "synthetic_bridge",
    "synthetic_eeg_trimodal",
    "synthetic_fmri",
    "train_val_split",
    "validate_dataset",
]
