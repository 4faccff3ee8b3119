"""EEG model family (PyTorch). Counterpart of ``ModelOutput`` and
``TriModalFusionNetV4`` in ``multimodal_eeg_fmri_tpu/models/eeg.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.encoders import (
    ConnMLPEncoder,
    ERPEncoder,
    PowerEncoder,
)
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.models.layers import (
    ClassifierHead,
    MultiHeadAttention,
)


class ModelOutput(NamedTuple):
    """Fixed output of every model."""

    logits: torch.Tensor                          # (B, num_classes)
    fused: Optional[torch.Tensor] = None          # (B, hidden) pre-head
    fusion_weights: Optional[torch.Tensor] = None  # (B, M)
    attn_weights: Optional[torch.Tensor] = None   # (B, Tq, Tk) head-averaged


class TriModalFusionNetV4(nn.Module):
    """ERP + PW + CONN tri-modal net with cross-modal attention and learned
    fusion."""

    def __init__(self, hidden_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.3, num_transformer_layers: int = 2,
                 num_heads: int = 4, erp_channels: int = 18,
                 pw_channels: int = 75, conn_features: int = 459,
                 device=None):
        super().__init__()
        self.erp_encoder = ERPEncoder(erp_channels, hidden_dim,
                                      num_transformer_layers, num_heads,
                                      dropout, device)
        self.pw_encoder = PowerEncoder(pw_channels, hidden_dim,
                                       num_transformer_layers, num_heads,
                                       dropout, device)
        self.conn_encoder = ConnMLPEncoder(conn_features, hidden_dim, dropout,
                                           device)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads, dropout,
                                             device=device)
        self.fusion = LearnedFusion(3, hidden_dim, device=device)
        self.classifier = ClassifierHead(
            hidden_dim, (hidden_dim, hidden_dim // 2), num_classes, dropout,
            device=device)

    def forward(self, *, erp: torch.Tensor, pw: torch.Tensor,
                conn: torch.Tensor) -> ModelOutput:
        erp_feat = self.erp_encoder(erp)
        pw_feat = self.pw_encoder(pw)
        conn_feat = self.conn_encoder(conn)
        # ERP queries the [erp, pw, conn] stack
        stack = torch.stack([erp_feat, pw_feat, conn_feat], dim=1)
        enhanced, attn_w = self.cross_attn(erp_feat[:, None], stack, stack)
        fused, weights = self.fusion([enhanced[:, 0], pw_feat, conn_feat])
        return ModelOutput(self.classifier(fused), fused, weights, attn_w)
