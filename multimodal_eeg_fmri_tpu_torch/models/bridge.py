"""EEG↔fMRI bridge fusion model (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/models/bridge.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.models.layers import (
    Dense,
    MultiHeadAttention,
    gelu,
    model_device,
)


class _Proj(nn.Module):
    def __init__(self, in_features: int, bridge_dim: int, dropout: float,
                 device=None):
        super().__init__()
        self.dropout = dropout
        self.dense = Dense(in_features, bridge_dim, device=device)
        self.ln = nn.LayerNorm(bridge_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(gelu(self.ln(self.dense(x))), self.dropout,
                         self.training)


class BridgeFusionNet(nn.Module):
    """Cross-modality bridge classifier over the two fused embeddings.
    Builds on the GPU unless ``device`` says otherwise."""

    def __init__(self, eeg_dim: int = 128, fmri_dim: int = 64,
                 bridge_dim: int = 128, num_classes: int = 2,
                 num_heads: int = 4, dropout: float = 0.3, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.dropout = dropout
        self.eeg_proj = _Proj(eeg_dim, bridge_dim, dropout, device)
        self.fmri_proj = _Proj(fmri_dim, bridge_dim, dropout, device)
        self.cross_attn = MultiHeadAttention(bridge_dim, num_heads, dropout,
                                             device=device)
        self.fusion = LearnedFusion(2, bridge_dim, device=device)
        self.cls_dense = Dense(bridge_dim, bridge_dim // 2, device=device)
        self.cls_ln = nn.LayerNorm(bridge_dim // 2, eps=1e-5, device=device)
        self.cls_out = Dense(bridge_dim // 2, num_classes, device=device)

    def forward(self, *, eeg: torch.Tensor, fmri: torch.Tensor
                ) -> ModelOutput:
        eeg_p = self.eeg_proj(eeg)
        fmri_p = self.fmri_proj(fmri)
        seq = torch.stack([eeg_p, fmri_p], dim=1)  # (B, 2, D)
        att, attn_w = self.cross_attn(eeg_p[:, None], seq, seq)
        fused, fusion_w = self.fusion([att[:, 0], fmri_p])
        x = F.relu(self.cls_ln(self.cls_dense(fused)))
        logits = self.cls_out(F.dropout(x, self.dropout, self.training))
        return ModelOutput(logits, fused, fusion_w, attn_w)
