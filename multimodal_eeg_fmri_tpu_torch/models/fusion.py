"""Fusion modules (PyTorch). Counterpart of ``LearnedFusion`` in
``multimodal_eeg_fmri_tpu/models/fusion.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.layers import gelu


class LearnedFusion(nn.Module):
    """Weighted sum of modality embeddings of width ``hidden_dim``:
    weights = 0.5·softmax(static_logits/T) + 0.5·softmax(gate(x_concat)/T).
    Returns (fused, combined_weights). The gate's dropout rate in training
    is the reference's fixed 0.2 whatever the model's ``dropout``;
    ``gate_dropout`` = 0 makes a train-mode forward deterministic."""

    def __init__(self, num_modalities: int, hidden_dim: int,
                 use_temperature: bool = True, init_temperature: float = 1.0,
                 device=None):
        super().__init__()
        self.num_modalities = num_modalities
        self.gate_dropout = 0.2
        self.fusion_logits = nn.Parameter(torch.ones(num_modalities,
                                                     device=device))
        self.temperature = nn.Parameter(torch.tensor(
            float(init_temperature), device=device)) if use_temperature else None
        self.init_temperature = init_temperature
        self.gate1 = nn.Linear(num_modalities * hidden_dim, hidden_dim,
                               device=device)
        self.gate2 = nn.Linear(hidden_dim, num_modalities, device=device)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(feats) != self.num_modalities:
            raise ValueError(f"expected {self.num_modalities} modalities, "
                             f"got {len(feats)}")
        stacked = torch.stack(tuple(feats), dim=1)  # (B, M, D)
        temp = self.temperature if self.temperature is not None else 1.0
        static_w = torch.softmax(self.fusion_logits / temp, dim=-1)
        gate = gelu(self.gate1(torch.cat(tuple(feats), dim=-1)))
        gate = self.gate2(F.dropout(gate, self.gate_dropout, self.training))
        dynamic_w = torch.softmax(gate / temp, dim=-1)  # (B, M)
        combined = 0.5 * static_w[None] + 0.5 * dynamic_w
        fused = (stacked * combined[..., None]).sum(dim=1)
        return fused, combined
