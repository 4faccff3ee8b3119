"""Operators of the port: ``attention`` holds the flash-attention kernels'
wrappers and their plain versions; ``signal`` the signal processing, with
the biquad-cascade kernel's wrapper (``sosfilt``) and its plain version;
``losses`` and ``augment`` the train step's losses and augmentation;
``moe`` the Mixture-of-Experts FFN and its routing; ``ring_attention``
sequence-parallel attention over a mesh axis;
``schedules`` the host-side LR and early-stopping controllers."""

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
from multimodal_eeg_fmri_tpu_torch.ops.moe import (
    MoEFFN,
    index_routing,
    top_k_routing,
)
from multimodal_eeg_fmri_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_local,
)
from multimodal_eeg_fmri_tpu_torch.ops.schedules import (
    EarlyStopping,
    ReduceLROnPlateau,
    warmup_cosine_schedule,
)

__all__ = [
    "EarlyStopping",
    "MoEFFN",
    "ReduceLROnPlateau",
    "attention",
    "augment_temporal",
    "cross_entropy",
    "flash_attention",
    "flash_attention_lse",
    "focal_loss",
    "index_routing",
    "kernel_launches",
    "label_smoothing_cross_entropy",
    "make_eeg_augment",
    "make_loss_fn",
    "mse_loss",
    "reference_attention",
    "reset_kernel_launches",
    "ring_attention",
    "ring_attention_local",
    "top_k_routing",
    "warmup_cosine_schedule",
    "weighted_cross_entropy",
]
