"""Train-time augmentation on the device (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/ops/augment.py``: with probability ``prob`` per
sample add gaussian noise at ``noise_std`` of the sample's std, and with
probability ``prob`` per sample zero a ``channel_dropout`` share of its
channels. The random numbers come from an explicit ``torch.Generator`` on the
tensor's device; they are not JAX's, so parity with the JAX package is
statistical.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def augment_temporal(generator: torch.Generator, x: torch.Tensor,
                     noise_std: float = 0.05, channel_dropout: float = 0.1,
                     prob: float = 0.3) -> torch.Tensor:
    """Gaussian noise + channel dropout on x (B, T, C), each gated
    per sample with ``prob``."""
    B, T, C = x.shape

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=x.device)

    std = x.std(dim=(1, 2), keepdim=True, correction=0)
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype) * (noise_std * std)
    x = torch.where(uniform(B, 1, 1) < prob, x + noise, x)
    keep = (uniform(B, 1, C) < 1.0 - channel_dropout).to(x.dtype)
    return torch.where(uniform(B, 1, 1) < prob, x * keep, x)


def make_eeg_augment(keys: Sequence[str] = ("erp", "pw"),
                     noise_std: float = 0.05, channel_dropout: float = 0.1,
                     prob: float = 0.3):
    """Batch-level hook for ``make_fit_fn(augment=...)``: temporal
    augmentation of the named (B, T, C) keys; the rest pass through."""

    def augment(generator: torch.Generator,
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        for k in keys:
            if k in batch and batch[k].dim() == 3:
                out[k] = augment_temporal(generator, batch[k], noise_std,
                                          channel_dropout, prob)
        return out

    return augment
