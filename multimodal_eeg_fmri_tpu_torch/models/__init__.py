"""Models of the serving slice, mirroring ``multimodal_eeg_fmri_tpu.models``."""

from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.models.eeg import (
    ModelOutput,
    TriModalFusionNetV4,
)
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
from multimodal_eeg_fmri_tpu_torch.models.multimodal import MultimodalEndToEnd

__all__ = [
    "BridgeFusionNet",
    "FMRIFusionNet",
    "ModelOutput",
    "MultimodalEndToEnd",
    "TriModalFusionNetV4",
]
