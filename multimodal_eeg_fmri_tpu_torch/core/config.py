"""Configuration of the port. A copy of the config classes of the JAX
package's ``core/config.py``, with the same fields and defaults:
``TrainConfig``, ``EEGConfig``, ``FMRIConfig``, ``BridgeConfig``,
``MeshConfig`` and ``ExperimentConfig``. ``save_config``/``load_config``
(YAML) are not ported yet."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping, Tuple


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


@dataclass(frozen=True)
class EEGConfig:
    """EEG pipeline config (reference ``EEG_CODE/config.py:19-80``)."""

    data_root: str = field(
        default_factory=lambda: os.environ.get("EEG_DATA_PATH", "./data/eeg")
    )
    # measured reference dims: ERP 18ch, PW 75 rows, CONN 459 = 3×C(18,2)
    erp_channels: int = 18
    pw_channels: int = 75
    conn_features: int = 459
    time_steps: int = 250
    num_classes: int = 2
    hidden_dim: int = 128
    lite_hidden_dim: int = 96
    dropout: float = 0.3
    lite_dropout: float = 0.4
    num_transformer_layers: int = 2
    num_heads: int = 4
    # >0 swaps the V4 temporal transformers' dense FFNs for a
    # Mixture-of-Experts FFN (not ported yet)
    num_experts: int = 0
    moe_top_k: int = 1
    conn_metrics: Tuple[str, ...] = ("plv", "coh", "wpli")
    freq_bands: Mapping[str, Tuple[float, float]] = field(
        default_factory=lambda: {
            "delta": (1.0, 4.0),
            "theta": (4.0, 8.0),
            "alpha": (8.0, 13.0),
            "beta": (13.0, 30.0),
            "gamma": (30.0, 45.0),
        }
    )
    sample_rate: float = 250.0
    n_splits: int = 5
    aggregate: str = "mean"  # per-subject sample aggregation
    augment_noise_std: float = 0.05
    augment_channel_dropout: float = 0.1
    augment_prob: float = 0.3

    def __hash__(self):  # dict field is not hashable by default
        return hash((self.erp_channels, self.pw_channels, self.conn_features,
                     self.time_steps, self.hidden_dim, self.num_heads,
                     self.num_transformer_layers, self.num_experts,
                     self.moe_top_k))


@dataclass(frozen=True)
class FMRIConfig:
    """fMRI pipeline config (reference ``fMRI_CODE/run_fmri_v11.py:43-77``)."""

    data_root: str = field(
        default_factory=lambda: os.environ.get("FMRI_DATA_PATH", "./data/fmri")
    )
    subjects: Tuple[int, ...] = tuple(range(1, 33))
    activation_types: Tuple[str, ...] = ("sensory", "AN", "LN", "cognitive",
                                         "DMN")
    connectivity_types: Tuple[str, ...] = ("DMN",)
    agg_method: str = "both"  # mean | std | both
    activation_dim: int = 0  # 0 = infer from data
    connectivity_dim: int = 0
    hidden_dim: int = 64
    fusion_dim: int = 128
    dropout: float = 0.4
    num_classes: int = 2
    n_splits: int = 5
    task: str = "classification"  # or "regression"


@dataclass(frozen=True)
class BridgeConfig:
    """Bridge pipeline config (reference ``_test_bridge.py:52-86``)."""

    eeg_dim: int = 128
    fmri_dim: int = 64
    bridge_dim: int = 128
    num_classes: int = 2
    num_heads: int = 4
    dropout: float = 0.3
    checkpoint_dir: str = "./checkpoints"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. ``ensemble`` shards independent model replicas
    (CV folds / HPO trials / ensemble members); ``data`` shards the batch.
    Axis size 0 means "infer from available devices". The port has no mesh
    yet (ROADMAP.md, queue A item 7)."""

    ensemble_axis: int = 0
    data_axis: int = 0
    axis_names: Tuple[str, str] = ("ensemble", "data")


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config tree serialized with every run."""

    train: TrainConfig = field(default_factory=TrainConfig)
    eeg: EEGConfig = field(default_factory=EEGConfig)
    fmri: FMRIConfig = field(default_factory=FMRIConfig)
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    output_dir: str = "./results"
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    experiment_name: str = "multimodal_eeg_fmri"
