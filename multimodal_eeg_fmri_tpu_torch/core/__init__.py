"""Configuration of the port."""

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig

__all__ = ["TrainConfig"]
