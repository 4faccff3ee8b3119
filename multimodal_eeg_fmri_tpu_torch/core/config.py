"""Configuration of the port. A copy of ``TrainConfig`` from the JAX
package's ``core/config.py``, with the same fields and defaults; the other
config classes are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters shared by all three pipelines.

    Defaults mirror the reference EEG pipeline (``EEG_CODE/config.py:40-51``):
    batch 8, 50 epochs, lr 5e-5, wd 1e-5, patience 10, grad-clip 1.0.
    """

    batch_size: int = 8
    num_epochs: int = 50
    learning_rate: float = 5e-5
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    patience: int = 10
    min_delta: float = 1e-3
    # "plateau" (ReduceLROnPlateau-like), "warmup_cosine", or "constant"
    schedule: str = "plateau"
    warmup_epochs: int = 3
    min_lr: float = 1e-6
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    # "weighted_ce" | "ce" | "focal" | "label_smoothing"
    loss: str = "weighted_ce"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    label_smoothing: float = 0.1
    # model selection: "val" (leakage-free), "test" (the reference EEG
    # k-fold behaviour) or "train_loss" (the bridge LOOCV behaviour)
    selection: str = "val"
    val_ratio: float = 0.15
    seed: int = 42
    # microbatches per optimizer step (must divide the batch); the summed
    # f32 gradients equal the full batch's
    grad_accum: int = 1
    # Polyak average of the params (not of the BatchNorm statistics); 0 = off
    ema_decay: float = 0.0
    # "float32" or "bfloat16": the train step's forward and backward run on
    # bf16 copies of the params and inputs, the master params, gradients,
    # AdamW state and running statistics stay f32, evaluation runs in f32
    compute_dtype: str = "float32"
