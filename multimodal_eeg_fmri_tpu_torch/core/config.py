"""Configuration of the port. A copy of the JAX package's
``core/config.py``, with the same fields and defaults: ``TrainConfig``,
``EEGConfig``, ``FMRIConfig``, ``BridgeConfig``, ``MeshConfig`` and
``ExperimentConfig``, and ``save_config`` / ``load_config``.

The JAX package reads and writes the config tree as YAML with PyYAML. The
port writes YAML where PyYAML imports; without it (the card's machine has
none) ``save_config`` writes the same tree as JSON, with every float in
exponent form given a decimal point ("1.0e-05"), which PyYAML's YAML 1.1
rules need to read it as a float. ``load_config`` reads a JSON file as
JSON and anything else as YAML. A JSON file is valid YAML, so one overlay
file serves both packages."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Tuple


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
    # Mixture-of-Experts FFN
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
    Axis size 0 means "infer from available devices". Nothing reads it,
    here or in the JAX package: ``parallel.mesh.build_mesh`` takes the
    sizes."""

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


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, Mapping):
        return {k: _to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_to_dict(v) for v in cfg]
    return cfg


def _from_dict(cls, d: Mapping[str, Any]):
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            continue
        f = hints[k]
        sub = f.type if isinstance(f.type, type) else None
        if (sub is not None and dataclasses.is_dataclass(sub)
                and isinstance(v, Mapping)):
            kwargs[k] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


_SECTIONS = {
    "train": TrainConfig,
    "eeg": EEGConfig,
    "fmri": FMRIConfig,
    "bridge": BridgeConfig,
    "mesh": MeshConfig,
}


def _yaml():
    """PyYAML, or None where it is not installed."""
    try:
        import yaml
    except ImportError:
        return None
    return yaml


# a JSON string, or a number in exponent form without a decimal point
_JSON_TOKEN = re.compile(r'"(?:\\.|[^"\\])*"|(-?\d+)([eE][-+]?\d+)')


def _yaml_safe_json(tree: Any) -> str:
    """``tree`` as JSON that PyYAML reads back alike: "1e-05" becomes
    "1.0e-05" (YAML 1.1 reads a float without a point as a string)."""
    return _JSON_TOKEN.sub(
        lambda m: m[0] if m[1] is None else f"{m[1]}.0{m[2]}",
        json.dumps(tree, indent=2))


def save_config(cfg: ExperimentConfig, path: str | Path) -> None:
    """Serialize the config tree (reference: ``Config.save_config``,
    ``EEG_CODE/config.py:75-80``): YAML as the JAX package writes it, or
    the same tree as JSON where PyYAML is not installed."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    yaml = _yaml()
    with open(path, "w") as f:
        if yaml is not None:
            yaml.safe_dump(_to_dict(cfg), f, sort_keys=False)
        else:
            f.write(_yaml_safe_json(_to_dict(cfg)) + "\n")


def load_config(path: str | Path) -> ExperimentConfig:
    """Load a JSON or YAML overlay into an ``ExperimentConfig``
    (reference: ``Config.load_config``, ``EEG_CODE/config.py:66-73``).
    Unknown keys are ignored; missing keys take defaults. Without PyYAML a
    file that is not JSON raises."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text) if text.strip() else {}
    except json.JSONDecodeError as e:
        yaml = _yaml()
        if yaml is None:
            raise ValueError(
                f"{path} is not JSON, and PyYAML is not installed to read it "
                f"as YAML: write the overlay as JSON (valid YAML too) or "
                f"install PyYAML") from e
        raw = yaml.safe_load(text) or {}
    kwargs: dict[str, Any] = {}
    for name, cls in _SECTIONS.items():
        if name in raw and isinstance(raw[name], Mapping):
            kwargs[name] = _from_dict(cls, raw[name])
    for k in ("output_dir", "checkpoint_dir", "log_dir", "experiment_name"):
        if k in raw:
            kwargs[k] = raw[k]
    return ExperimentConfig(**kwargs)
