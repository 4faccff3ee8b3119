"""fMRI model family (PyTorch). Counterpart of ``FMRIEncoder``, ``_Head``
and ``FMRIFusionNet`` in ``multimodal_eeg_fmri_tpu/models/fmri.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.models.layers import MLP, model_device


class FMRIEncoder(nn.Module):
    """in → 2·hidden → hidden MLP with BN/ReLU/dropout."""

    def __init__(self, in_features: int, hidden_dim: int = 64,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.mlp = MLP(in_features, (2 * hidden_dim, hidden_dim), dropout,
                       norm="batch", activation=F.relu, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class _Head(nn.Module):
    def __init__(self, hidden_dim: int, num_classes: int, dropout: float,
                 task: str, device=None):
        super().__init__()
        if task not in ("classification", "regression"):
            raise ValueError(f"unknown task {task!r}")
        self.dropout = dropout
        self.task = task
        self.dense = nn.Linear(hidden_dim, hidden_dim // 2, device=device)
        self.out = nn.Linear(hidden_dim // 2,
                             num_classes if task == "classification" else 1,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.dropout(F.relu(self.dense(x)), self.dropout, self.training)
        x = self.out(x)
        return x[..., 0] if self.task == "regression" else x


class FMRIFusionNet(nn.Module):
    """Two encoders, a softmaxed pair of learned scalar weights, concat →
    fuse MLP → head. ``fused`` is the pre-head fusion embedding. Builds on
    the GPU unless ``device`` says otherwise."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 2,
                 dropout: float = 0.4, task: str = "classification",
                 activation_features: int = 90,
                 connectivity_features: int = 64, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.activation_encoder = FMRIEncoder(activation_features, hidden_dim,
                                              dropout, device)
        self.connectivity_encoder = FMRIEncoder(connectivity_features,
                                                hidden_dim, dropout, device)
        self.activation_weight = nn.Parameter(torch.full((1,), 0.5,
                                                         device=device))
        self.connectivity_weight = nn.Parameter(torch.full((1,), 0.5,
                                                           device=device))
        self.fusion = MLP(2 * hidden_dim, (hidden_dim,), dropout,
                          norm="batch", activation=F.relu, device=device)
        self.head = _Head(hidden_dim, num_classes, dropout, task, device)

    def forward(self, *, activation: torch.Tensor,
                connectivity: torch.Tensor) -> ModelOutput:
        act_feat = self.activation_encoder(activation)
        conn_feat = self.connectivity_encoder(connectivity)
        w = torch.softmax(torch.cat([self.activation_weight,
                                     self.connectivity_weight]), dim=0)
        fused = self.fusion(torch.cat([act_feat * w[0], conn_feat * w[1]],
                                      dim=-1))
        weights = w[None].expand(activation.shape[0], 2)
        return ModelOutput(self.head(fused), fused, weights, None)
