"""EEG model family (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/models/eeg.py``: ``ModelOutput``, the tri-modal
V4 net, the bi-modal ``SmartFusionNetV4``, V4-Lite, the graph net and the
V3 unimodal baselines.

Every model takes its inputs as keywords ``erp``, ``pw``, ``conn`` (the
entry points call ``model(**inputs)``), and accepts the ones it does not
use. Each builds on the GPU unless ``device`` says otherwise. At T ≥ 512
the V4 encoders' four temporal self-attention layers take the flash
kernels (``models/layers.py:MultiHeadAttention``'s "auto" rule), in
``TriModalFusionNetV4``, ``SmartFusionNetV4`` and ``TriModalFusionNetGNN``
alike; the conv-only nets and the 2-token cross-attentions launch none.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.encoders import (
    AttnConnEncoder,
    ConnMLPEncoder,
    ERPEncoder,
    ERPEncoderV3,
    GraphConnEncoder,
    LiteERPEncoder,
    LitePowerEncoder,
    PowerEncoder,
    PowerEncoderV3,
)
from multimodal_eeg_fmri_tpu_torch.models.fusion import (
    BiDirectionalCrossAttention,
    HybridFusion,
    LearnedFusion,
)
from multimodal_eeg_fmri_tpu_torch.models.layers import (
    ClassifierHead,
    MultiHeadAttention,
    model_device,
)


class ModelOutput(NamedTuple):
    """Fixed output of every model."""

    logits: torch.Tensor                          # (B, num_classes)
    fused: Optional[torch.Tensor] = None          # (B, hidden) pre-head
    fusion_weights: Optional[torch.Tensor] = None  # (B, M)
    attn_weights: Optional[torch.Tensor] = None   # (B, Tq, Tk) head-averaged


class TriModalFusionNetV4(nn.Module):
    """ERP + PW + CONN tri-modal net with cross-modal attention and learned
    fusion. With ``num_experts`` > 0 the ERP and PW temporal transformers
    take Mixture-of-Experts FFNs (``ops.moe.MoEFFN``, top-``moe_top_k``),
    whose load-balance loss ``fit`` adds in training; ``mesh`` and
    ``expert_axis`` shard their experts (expert parallelism,
    ``parallel.expert``), the batch over the mesh's ``data`` axis. Builds
    on the GPU unless ``device`` says otherwise."""

    def __init__(self, hidden_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.3, num_transformer_layers: int = 2,
                 num_heads: int = 4, erp_channels: int = 18,
                 pw_channels: int = 75, conn_features: int = 459,
                 device="cuda", num_experts: int = 0, moe_top_k: int = 1,
                 mesh=None, expert_axis: Optional[str] = None):
        super().__init__()
        device = model_device(device)
        self.mesh = mesh
        _v4_encoders(self, erp_channels, pw_channels, hidden_dim,
                     num_transformer_layers, num_heads, dropout, device,
                     num_experts, moe_top_k, mesh, expert_axis)
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
        return _trimodal(self, erp, pw, conn)


def _trimodal(net: nn.Module, erp, pw, conn) -> ModelOutput:
    """The tri-modal forward of V4 and the graph net: three encoders, ERP
    querying the [erp, pw, conn] stack, learned fusion, the head."""
    erp_feat = net.erp_encoder(erp)
    pw_feat = net.pw_encoder(pw)
    conn_feat = net.conn_encoder(conn)
    stack = torch.stack([erp_feat, pw_feat, conn_feat], dim=1)
    enhanced, attn_w = net.cross_attn(erp_feat[:, None], stack, stack)
    fused, weights = net.fusion([enhanced[:, 0], pw_feat, conn_feat])
    return ModelOutput(net.classifier(fused), fused, weights, attn_w)


def _v4_encoders(net: nn.Module, erp_channels, pw_channels, hidden_dim,
                 num_transformer_layers, num_heads, dropout, device,
                 num_experts: int = 0, moe_top_k: int = 1, mesh=None,
                 expert_axis: Optional[str] = None) -> None:
    moe = dict(num_experts=num_experts, moe_top_k=moe_top_k, mesh=mesh,
               expert_axis=expert_axis)
    net.erp_encoder = ERPEncoder(erp_channels, hidden_dim,
                                 num_transformer_layers, num_heads, dropout,
                                 device, **moe)
    net.pw_encoder = PowerEncoder(pw_channels, hidden_dim,
                                  num_transformer_layers, num_heads, dropout,
                                  device, **moe)


class SmartFusionNetV4(nn.Module):
    """Bi-modal (ERP + PW) net with optional bi-directional cross-attention.
    ``conn`` is accepted and ignored."""

    def __init__(self, hidden_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.4, num_transformer_layers: int = 2,
                 num_heads: int = 4, use_cross_attention: bool = True,
                 erp_channels: int = 18, pw_channels: int = 75,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        _v4_encoders(self, erp_channels, pw_channels, hidden_dim,
                     num_transformer_layers, num_heads, dropout, device)
        self.cross_attention = BiDirectionalCrossAttention(
            hidden_dim, num_heads, dropout, device) if use_cross_attention \
            else None
        self.fusion = LearnedFusion(2, hidden_dim, device=device)
        self.classifier = ClassifierHead(
            hidden_dim, (hidden_dim, hidden_dim // 2), num_classes, dropout,
            device=device)

    def forward(self, *, erp: torch.Tensor, pw: torch.Tensor,
                conn: Optional[torch.Tensor] = None) -> ModelOutput:
        erp_feat = self.erp_encoder(erp)
        pw_feat = self.pw_encoder(pw)
        if self.cross_attention is not None:
            erp_feat, pw_feat = self.cross_attention(erp_feat, pw_feat)
        fused, weights = self.fusion([erp_feat, pw_feat])
        return ModelOutput(self.classifier(fused), fused, weights, None)


class TriModalFusionNetV4Lite(nn.Module):
    """Lite tri-modal net for small datasets: conv-only encoders, hybrid
    fusion with the connectivity boosted, a one-layer head."""

    def __init__(self, hidden_dim: int = 96, num_classes: int = 2,
                 dropout: float = 0.4, conn_boost: float = 1.3,
                 erp_channels: int = 18, pw_channels: int = 75,
                 conn_features: int = 459, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.erp_encoder = LiteERPEncoder(erp_channels, hidden_dim, dropout,
                                          device)
        self.pw_encoder = LitePowerEncoder(pw_channels, hidden_dim, dropout,
                                           device)
        self.conn_encoder = AttnConnEncoder(conn_features, hidden_dim,
                                            dropout, device)
        self.fusion = HybridFusion(hidden_dim, dropout, conn_boost, device)
        self.classifier = ClassifierHead(hidden_dim, (hidden_dim // 2,),
                                         num_classes, dropout, device=device)

    def forward(self, *, erp: torch.Tensor, pw: torch.Tensor,
                conn: torch.Tensor) -> ModelOutput:
        fused, weights = self.fusion(self.erp_encoder(erp),
                                     self.pw_encoder(pw),
                                     self.conn_encoder(conn))
        return ModelOutput(self.classifier(fused), fused, weights, None)


class TriModalFusionNetGNN(nn.Module):
    """Tri-modal net with the graph-attention connectivity encoder;
    ``conn`` is the (B, N, N, M) matrix form, N = ``n_nodes`` and
    M = ``n_metrics``."""

    def __init__(self, hidden_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.3, num_transformer_layers: int = 2,
                 num_heads: int = 4, gnn_threshold: float = 0.5,
                 erp_channels: int = 18, pw_channels: int = 75,
                 n_nodes: int = 18, n_metrics: int = 3, device="cuda"):
        super().__init__()
        device = model_device(device)
        _v4_encoders(self, erp_channels, pw_channels, hidden_dim,
                     num_transformer_layers, num_heads, dropout, device)
        self.conn_encoder = GraphConnEncoder(n_nodes, n_metrics, hidden_dim,
                                             num_heads, gnn_threshold,
                                             dropout, device)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads, dropout,
                                             device=device)
        self.fusion = LearnedFusion(3, hidden_dim, device=device)
        self.classifier = ClassifierHead(
            hidden_dim, (hidden_dim, hidden_dim // 2), num_classes, dropout,
            device=device)

    def forward(self, *, erp: torch.Tensor, pw: torch.Tensor,
                conn: torch.Tensor) -> ModelOutput:
        return _trimodal(self, erp, pw, conn)


class _UnimodalNet(nn.Module):
    """A V3 conv encoder and a one-layer head over one modality."""

    def __init__(self, encoder: nn.Module, hidden_dim: int, num_classes: int,
                 dropout: float, device):
        super().__init__()
        self.encoder = encoder
        self.classifier = ClassifierHead(hidden_dim, (hidden_dim // 2,),
                                         num_classes, dropout, device=device)

    def _classify(self, x: torch.Tensor) -> ModelOutput:
        feat = self.encoder(x)
        return ModelOutput(self.classifier(feat), feat, None, None)


class ERPOnlyNet(_UnimodalNet):
    """V3 unimodal ERP baseline: conv encoder and a 2-layer head. ``pw``
    and ``conn`` are accepted and ignored."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 2,
                 dropout: float = 0.5, erp_channels: int = 18,
                 device="cuda"):
        device = model_device(device)
        super().__init__(ERPEncoderV3(erp_channels, hidden_dim, dropout,
                                      device),
                         hidden_dim, num_classes, dropout, device)

    def forward(self, *, erp: torch.Tensor,
                pw: Optional[torch.Tensor] = None,
                conn: Optional[torch.Tensor] = None) -> ModelOutput:
        return self._classify(erp)


class PWOnlyNet(_UnimodalNet):
    """V3 unimodal power-spectrum baseline. ``erp`` and ``conn`` are
    accepted and ignored."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 2,
                 dropout: float = 0.5, pw_channels: int = 75,
                 device="cuda"):
        device = model_device(device)
        super().__init__(PowerEncoderV3(pw_channels, hidden_dim, dropout,
                                        device),
                         hidden_dim, num_classes, dropout, device)

    def forward(self, *, pw: torch.Tensor,
                erp: Optional[torch.Tensor] = None,
                conn: Optional[torch.Tensor] = None) -> ModelOutput:
        return self._classify(pw)
