"""Configuration and checkpoints of the port."""

from multimodal_eeg_fmri_tpu_torch.core.checkpoint import (
    export_frozen_encoder,
    find_best_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig

__all__ = ["TrainConfig", "export_frozen_encoder", "find_best_checkpoint",
           "load_checkpoint", "save_checkpoint"]
