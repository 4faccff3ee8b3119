"""Batched XAI on the model's device (PyTorch): saliency, integrated
gradients, ablation, SHAP, attention/fusion-weight extraction, montage
mapping. Counterpart of ``multimodal_eeg_fmri_tpu/xai``."""

from multimodal_eeg_fmri_tpu_torch.xai.analysis import (
    ChannelImportance,
    channel_importance_from_attribution,
    classwise_weight_comparison,
    connectivity_pair_importance,
    extract_attention_and_fusion_weights,
)
from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
    ablation_importance,
    gradient_saliency,
    gradient_x_input,
    integrated_gradients,
    make_apply_fn,
)
from multimodal_eeg_fmri_tpu_torch.xai.explainer import (
    Explainer,
    ExplanationResult,
)
from multimodal_eeg_fmri_tpu_torch.xai.montage import (
    CHANNEL_NAMES_18,
    CHANNEL_POSITIONS,
    REGION_GROUPS,
    channel_region,
)
from multimodal_eeg_fmri_tpu_torch.xai.shap_kernel import (
    kernel_shap,
    make_class_prob_fn,
)

__all__ = [
    "gradient_saliency",
    "gradient_x_input",
    "integrated_gradients",
    "ablation_importance",
    "make_apply_fn",
    "kernel_shap",
    "make_class_prob_fn",
    "CHANNEL_NAMES_18",
    "CHANNEL_POSITIONS",
    "REGION_GROUPS",
    "channel_region",
    "Explainer",
    "ExplanationResult",
    "ChannelImportance",
    "channel_importance_from_attribution",
    "classwise_weight_comparison",
    "connectivity_pair_importance",
    "extract_attention_and_fusion_weights",
]
