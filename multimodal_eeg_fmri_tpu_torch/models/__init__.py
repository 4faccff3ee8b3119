"""The model zoo, mirroring ``multimodal_eeg_fmri_tpu.models``.

``MODEL_REGISTRY`` maps the JAX package's registry names to the port's
classes, every one of them. ``PipelinedLongContextClassifier``, which the
JAX package exports beside them, waits for the pipeline (ROADMAP.md,
queue A item 7a).
"""

from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.models.eeg import (
    ERPOnlyNet,
    ModelOutput,
    PWOnlyNet,
    SmartFusionNetV4,
    TriModalFusionNetGNN,
    TriModalFusionNetV4,
    TriModalFusionNetV4Lite,
)
from multimodal_eeg_fmri_tpu_torch.models.fmri import (
    FMRIActivationOnly,
    FMRIConnectivityOnly,
    FMRIFusionNet,
)
from multimodal_eeg_fmri_tpu_torch.models.long_context import (
    LongContextClassifier,
)
from multimodal_eeg_fmri_tpu_torch.models.multimodal import MultimodalEndToEnd

MODEL_REGISTRY = {
    "trimodal": TriModalFusionNetV4,
    "trimodal_lite": TriModalFusionNetV4Lite,
    "trimodal_gnn": TriModalFusionNetGNN,
    "fusion": SmartFusionNetV4,           # bi-modal ERP+PW (reference name)
    "erponly": ERPOnlyNet,
    "pwonly": PWOnlyNet,
    "fmri_fusion": FMRIFusionNet,
    "fmri_activation_only": FMRIActivationOnly,
    "fmri_connectivity_only": FMRIConnectivityOnly,
    "bridge": BridgeFusionNet,
    "multimodal_e2e": MultimodalEndToEnd,
    "long_context": LongContextClassifier,
}

__all__ = [
    "BridgeFusionNet",
    "ERPOnlyNet",
    "FMRIActivationOnly",
    "FMRIConnectivityOnly",
    "FMRIFusionNet",
    "LongContextClassifier",
    "MODEL_REGISTRY",
    "ModelOutput",
    "MultimodalEndToEnd",
    "PWOnlyNet",
    "SmartFusionNetV4",
    "TriModalFusionNetGNN",
    "TriModalFusionNetV4",
    "TriModalFusionNetV4Lite",
]
