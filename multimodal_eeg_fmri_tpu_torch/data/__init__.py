"""Dataset helpers of the port (numpy)."""

from multimodal_eeg_fmri_tpu_torch.data.arrays import (
    balanced_class_weights,
    pad_rows,
    subset,
    validate_dataset,
)

__all__ = ["balanced_class_weights", "pad_rows", "subset", "validate_dataset"]
