"""End-to-end fused EEG+fMRI model (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/models/multimodal.py``: the EEG tri-modal net, the
fMRI fusion net and the bridge head as one module. ``freeze_encoders=True``
detaches the two embeddings, the reference's two-stage semantics."""

from __future__ import annotations

import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.models.eeg import (
    ModelOutput,
    TriModalFusionNetV4,
)
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
from multimodal_eeg_fmri_tpu_torch.models.layers import model_device


class MultimodalEndToEnd(nn.Module):
    """EEG tri-modal encoder + fMRI fusion encoder + bridge head. Builds on
    the GPU unless ``device`` says otherwise."""

    def __init__(self, eeg_hidden_dim: int = 128, fmri_hidden_dim: int = 64,
                 bridge_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.3, num_transformer_layers: int = 2,
                 num_heads: int = 4, freeze_encoders: bool = False,
                 erp_channels: int = 18, pw_channels: int = 75,
                 conn_features: int = 459, activation_features: int = 90,
                 connectivity_features: int = 64, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.freeze_encoders = freeze_encoders
        self.eeg = TriModalFusionNetV4(
            eeg_hidden_dim, num_classes, dropout, num_transformer_layers,
            num_heads, erp_channels, pw_channels, conn_features, device)
        self.fmri = FMRIFusionNet(
            fmri_hidden_dim, num_classes, dropout,
            activation_features=activation_features,
            connectivity_features=connectivity_features, device=device)
        self.bridge = BridgeFusionNet(eeg_hidden_dim, fmri_hidden_dim,
                                      bridge_dim, num_classes, num_heads,
                                      dropout, device)

    def forward(self, *, erp: torch.Tensor, pw: torch.Tensor,
                conn: torch.Tensor, activation: torch.Tensor,
                connectivity: torch.Tensor) -> ModelOutput:
        eeg_emb = self.eeg(erp=erp, pw=pw, conn=conn).fused
        fmri_emb = self.fmri(activation=activation,
                             connectivity=connectivity).fused
        if self.freeze_encoders:
            eeg_emb, fmri_emb = eeg_emb.detach(), fmri_emb.detach()
        return self.bridge(eeg=eeg_emb, fmri=fmri_emb)
