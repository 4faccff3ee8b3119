"""PyTorch port of multimodal_eeg_fmri_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and class names. Plain tensor code is
PyTorch; the JAX package's Pallas TPU kernels become hand-written CUDA
kernels under ``csrc/``, built at first use (``ops/_kernels.py``). Imports
neither jax nor the JAX package.
"""

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.convert import (
    init_weights,
    load_flax_variables,
)
from multimodal_eeg_fmri_tpu_torch.models import (
    ModelOutput,
    MultimodalEndToEnd,
)
from multimodal_eeg_fmri_tpu_torch.serving import Predictor
from multimodal_eeg_fmri_tpu_torch.train.fit import FitResult, fit, make_fit_fn

__all__ = [
    "FitResult",
    "ModelOutput",
    "MultimodalEndToEnd",
    "Predictor",
    "TrainConfig",
    "fit",
    "init_weights",
    "load_flax_variables",
    "make_fit_fn",
]
