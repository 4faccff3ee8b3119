"""Configuration, seeds and checkpoints of the port."""

from multimodal_eeg_fmri_tpu_torch.core.checkpoint import (
    export_frozen_encoder,
    find_best_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_eeg_fmri_tpu_torch.core.config import (
    BridgeConfig,
    EEGConfig,
    ExperimentConfig,
    FMRIConfig,
    MeshConfig,
    TrainConfig,
)
from multimodal_eeg_fmri_tpu_torch.core.rng import (
    RngStream,
    fold_in,
    seed_everything,
)

__all__ = ["BridgeConfig", "EEGConfig", "ExperimentConfig", "FMRIConfig",
           "MeshConfig", "RngStream", "TrainConfig", "export_frozen_encoder",
           "find_best_checkpoint", "fold_in", "load_checkpoint",
           "save_checkpoint", "seed_everything"]
