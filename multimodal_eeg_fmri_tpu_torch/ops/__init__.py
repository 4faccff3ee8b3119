"""Operators of the port; ``attention`` holds the flash-attention kernel's
wrappers and their plain versions."""

from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    attention,
    flash_attention,
    flash_attention_lse,
    reference_attention,
)

__all__ = [
    "attention",
    "flash_attention",
    "flash_attention_lse",
    "reference_attention",
]
