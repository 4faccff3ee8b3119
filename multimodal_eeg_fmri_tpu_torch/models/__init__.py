"""The model zoo, mirroring ``multimodal_eeg_fmri_tpu.models``.

``MODEL_REGISTRY`` maps the JAX package's registry names to the port's
classes, every one of them; ``PipelinedLongContextClassifier`` is
exported beside them, as the JAX package exports it.
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
    PipelinedLongContextClassifier,
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
    "PipelinedLongContextClassifier",
    "SmartFusionNetV4",
    "TriModalFusionNetGNN",
    "TriModalFusionNetV4",
    "TriModalFusionNetV4Lite",
]
