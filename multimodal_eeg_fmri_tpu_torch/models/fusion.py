"""Fusion modules (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/models/fusion.py``: ``LearnedFusion``,
``BiDirectionalCrossAttention`` and ``HybridFusion``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.layers import (
    MLP,
    Dense,
    MultiHeadAttention,
    gelu,
    softmax,
)


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
        self.gate1 = Dense(num_modalities * hidden_dim, hidden_dim,
                           device=device)
        self.gate2 = Dense(hidden_dim, num_modalities, device=device)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(feats) != self.num_modalities:
            raise ValueError(f"expected {self.num_modalities} modalities, "
                             f"got {len(feats)}")
        stacked = torch.stack(tuple(feats), dim=1)  # (B, M, D)
        temp = self.temperature if self.temperature is not None else 1.0
        static_w = softmax(self.fusion_logits / temp, dim=-1)
        gate = gelu(self.gate1(torch.cat(tuple(feats), dim=-1)))
        gate = self.gate2(F.dropout(gate, self.gate_dropout, self.training))
        dynamic_w = softmax(gate / temp, dim=-1)  # (B, M)
        combined = 0.5 * static_w[None] + 0.5 * dynamic_w
        fused = (stacked * combined[..., None]).sum(dim=1)
        return fused, combined


class BiDirectionalCrossAttention(nn.Module):
    """Mutual cross-modal attention between two embeddings of width
    ``hidden_dim``: each modality, as a 1-token query, attends over the
    2-token [erp, pw] stack (always the einsum route); a sigmoid gate on
    [x, attended] scales the attended residual, then LayerNorm. One dropout
    rate serves both residuals, each drawing its own mask."""

    def __init__(self, hidden_dim: int, num_heads: int = 4,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.dropout = dropout
        self.erp_to_pw = MultiHeadAttention(hidden_dim, num_heads, dropout,
                                            device=device)
        self.pw_to_erp = MultiHeadAttention(hidden_dim, num_heads, dropout,
                                            device=device)
        self.erp_gate = Dense(2 * hidden_dim, hidden_dim, device=device)
        self.pw_gate = Dense(2 * hidden_dim, hidden_dim, device=device)
        self.norm_erp = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.norm_pw = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)

    def forward(self, erp: torch.Tensor, pw: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        combined = torch.stack([erp, pw], dim=1)  # (B, 2, D)
        out = []
        for x, attn, gate, norm in (
                (erp, self.erp_to_pw, self.erp_gate, self.norm_erp),
                (pw, self.pw_to_erp, self.pw_gate, self.norm_pw)):
            att = attn(x[:, None], combined, combined)[0][:, 0]
            g = torch.sigmoid(gate(torch.cat([x, att], dim=-1)))
            out.append(norm(x + F.dropout(g * att, self.dropout,
                                          self.training)))
        return out[0], out[1]


class HybridFusion(nn.Module):
    """Early gated ERP+PW fusion, late concat with the connectivity
    embedding scaled by ``conn_boost``, and a learned ``final_gate``
    (initially [0.6, 0.4]). Returns (fused, weight_summary), the summary
    (B, 3) being [erp_w·final_0, pw_w·final_0, final_1·conn_boost]."""

    def __init__(self, hidden_dim: int, dropout: float = 0.3,
                 conn_boost: float = 1.2, device=None):
        super().__init__()
        self.dropout = dropout
        self.conn_boost = conn_boost
        self.gate1 = Dense(2 * hidden_dim, hidden_dim, device=device)
        self.gate2 = Dense(hidden_dim, 2, device=device)
        self.final_gate = nn.Parameter(torch.tensor([0.6, 0.4],
                                                    device=device))
        self.late = MLP(2 * hidden_dim, (hidden_dim,), dropout, norm="batch",
                        device=device)

    def forward(self, erp: torch.Tensor, pw: torch.Tensor,
                conn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        g = gelu(self.gate1(torch.cat([erp, pw], dim=-1)))
        g = self.gate2(F.dropout(g, self.dropout, self.training))
        g = softmax(g, dim=-1)  # (B, 2)
        early = g[:, 0:1] * erp + g[:, 1:2] * pw
        final_w = softmax(self.final_gate, dim=-1)
        fused = self.late(torch.cat([early, conn * self.conn_boost], dim=-1))
        weights = torch.stack(
            [g[:, 0] * final_w[0], g[:, 1] * final_w[0],
             (final_w[1] * self.conn_boost).expand(g.shape[0])], dim=-1)
        return fused, weights
