"""Operators of the port: ``attention`` holds the flash-attention kernels'
wrappers and their plain versions; ``losses`` and ``augment`` the train
step's losses and augmentation."""

from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    attention,
    flash_attention,
    flash_attention_lse,
    kernel_launches,
    reference_attention,
    reset_kernel_launches,
)
from multimodal_eeg_fmri_tpu_torch.ops.augment import (
    augment_temporal,
    make_eeg_augment,
)
from multimodal_eeg_fmri_tpu_torch.ops.losses import (
    cross_entropy,
    focal_loss,
    label_smoothing_cross_entropy,
    make_loss_fn,
    mse_loss,
    weighted_cross_entropy,
)

__all__ = [
    "attention",
    "augment_temporal",
    "cross_entropy",
    "flash_attention",
    "flash_attention_lse",
    "focal_loss",
    "kernel_launches",
    "label_smoothing_cross_entropy",
    "make_eeg_augment",
    "make_loss_fn",
    "mse_loss",
    "reference_attention",
    "reset_kernel_launches",
    "weighted_cross_entropy",
]
