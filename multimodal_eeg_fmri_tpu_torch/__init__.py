"""PyTorch port of multimodal_eeg_fmri_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and class names. Plain tensor code is
PyTorch; the JAX package's Pallas TPU kernels become hand-written CUDA
kernels under ``csrc/``, built at first use (``ops/_kernels.py``). Imports
neither jax nor the JAX package. ``python -m multimodal_eeg_fmri_tpu_torch
--pipeline eeg|fmri|bridge|lite|all`` runs the experiment pipelines
(``pipelines.py``).
"""

__version__ = "0.1.0"

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.convert import (
    carry_from_jax,
    init_weights,
    load_flax_variables,
)
from multimodal_eeg_fmri_tpu_torch.models import (
    ModelOutput,
    MultimodalEndToEnd,
)
from multimodal_eeg_fmri_tpu_torch.serving import (
    DynamicBatcher,
    EnsemblePredictor,
    Predictor,
    QueueFull,
    load_artifact,
)
from multimodal_eeg_fmri_tpu_torch.train import (
    FitCarry,
    FitResult,
    Trainer,
    evaluate_dataset,
    fit,
    fit_resumable,
    make_fit_fn,
)

__all__ = [
    "DynamicBatcher",
    "EnsemblePredictor",
    "FitCarry",
    "FitResult",
    "ModelOutput",
    "MultimodalEndToEnd",
    "Predictor",
    "QueueFull",
    "TrainConfig",
    "Trainer",
    "carry_from_jax",
    "evaluate_dataset",
    "fit",
    "fit_resumable",
    "init_weights",
    "load_artifact",
    "load_flax_variables",
    "make_fit_fn",
]
