"""Modality encoders (PyTorch, channels-last ``(B, T, C)``).

Counterpart of ``multimodal_eeg_fmri_tpu/models/encoders.py``: the V4
encoders, the V4-Lite encoders, the graph-attention connectivity encoder
and the V3 baselines' conv stacks. Flax infers input widths at the first
call; here they are constructor arguments, with the reference data's
widths as defaults.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.layers import (
    MLP,
    Conv1d,
    Dense,
    PositionalEncoding,
    TransformerBlock,
    batch_norm,
    gelu,
    softmax,
)


class ConvBNBlock(nn.Module):
    """Conv1d ("SAME", odd kernel) + BatchNorm + GELU [+ dropout]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("'SAME' padding is ported for odd kernels only")
        self.dropout = dropout
        self.conv = Conv1d(in_channels, features, kernel_size,
                           padding=kernel_size // 2, device=device)
        self.bn = batch_norm(features, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # BatchNorm on (B, C, T) normalises over batch and time, as flax
        # does over every axis but the last
        x = gelu(self.bn(self.conv(x.transpose(1, 2)))).transpose(1, 2)
        return F.dropout(x, self.dropout, self.training)


def max_pool_time(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max-pool along time (dim 1) with stride == window."""
    return F.max_pool1d(x.transpose(1, 2), window).transpose(1, 2)


class ERPEncoder(nn.Module):
    """CNN + temporal-transformer ERP encoder (V4 'enhanced'); with
    ``num_experts`` > 0 each transformer block's FFN is a Mixture of
    Experts, sharded over ``expert_axis`` of ``mesh`` where given."""

    def __init__(self, in_channels: int = 18, hidden_dim: int = 128,
                 num_transformer_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.3, device=None,
                 num_experts: int = 0, moe_top_k: int = 1, mesh=None,
                 expert_axis: Optional[str] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = ConvBNBlock(in_channels, 64, 7, dropout, device)
        self.conv2 = ConvBNBlock(64, 128, 5, device=device)
        self.conv3 = ConvBNBlock(128, hidden_dim, 3, dropout, device)
        self.pos = PositionalEncoding(hidden_dim, dropout)
        self.n_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            self.add_module(f"transformer_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout, num_experts=num_experts,
                moe_top_k=moe_top_k, device=device, mesh=mesh,
                expert_axis=expert_axis))
        self.proj = Dense(hidden_dim, hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        x = F.dropout(max_pool_time(x, 2), self.dropout, self.training)
        x = self.pos(self.conv3(x))
        for i in range(self.n_layers):
            x = getattr(self, f"transformer_{i}")(x)
        x = gelu(self.proj(x.mean(dim=1)))
        return F.dropout(x, self.dropout, self.training)


class MultiScaleConv(nn.Module):
    """Three conv branches (k=3, 5, 7) as ONE k=7 conv whose taps outside a
    branch's window are masked to zero. The kernel keeps flax's
    ``(7, C_in, 3·f)`` layout so that it converts one to one."""

    def __init__(self, in_channels: int, branch_features: int = 64,
                 device=None):
        super().__init__()
        f = branch_features
        self.kernel = nn.Parameter(torch.empty(7, in_channels, 3 * f,
                                               device=device))
        # torch's default for a conv weight, as nn.Conv1d draws it:
        # U(±1/√fan_in) over the 7·C_in taps (convert.init_weights draws
        # flax's)
        bound = 1.0 / math.sqrt(7 * in_channels)
        nn.init.uniform_(self.kernel, -bound, bound)
        self.bias = nn.Parameter(torch.zeros(3 * f, device=device))
        self.bn = batch_norm(3 * f, device)
        # branch 0 sees taps 2..4, branch 1 taps 1..5, branch 2 all seven
        taps = torch.arange(7, device=device)[:, None, None]
        branch = torch.arange(3, device=device).repeat_interleave(f)[None, None]
        lo = torch.tensor([2, 1, 0], device=device)[branch]
        hi = torch.tensor([4, 5, 6], device=device)[branch]
        self.register_buffer("mask", ((taps >= lo) & (taps <= hi)).float(),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.kernel * self.mask.to(self.kernel.dtype)).permute(2, 1, 0)
        y = F.conv1d(x.transpose(1, 2), w, padding=3) + self.bias[:, None]
        return gelu(self.bn(y)).transpose(1, 2)


class PowerEncoder(nn.Module):
    """Multi-scale CNN + transformer power-spectrum encoder (V4); MoE
    FFNs as in ``ERPEncoder``."""

    def __init__(self, in_channels: int = 75, hidden_dim: int = 128,
                 num_transformer_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.3, device=None,
                 num_experts: int = 0, moe_top_k: int = 1, mesh=None,
                 expert_axis: Optional[str] = None):
        super().__init__()
        self.dropout = dropout
        self.multiscale = MultiScaleConv(in_channels, 64, device)
        self.fuse = ConvBNBlock(192, hidden_dim, 1, dropout, device)
        self.pos = PositionalEncoding(hidden_dim, dropout)
        self.n_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            self.add_module(f"transformer_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout, num_experts=num_experts,
                moe_top_k=moe_top_k, device=device, mesh=mesh,
                expert_axis=expert_axis))
        self.proj = Dense(hidden_dim, hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pos(self.fuse(self.multiscale(x)))
        for i in range(self.n_layers):
            x = getattr(self, f"transformer_{i}")(x)
        x = gelu(self.proj(x.mean(dim=1)))
        return F.dropout(x, self.dropout, self.training)


class ConnMLPEncoder(nn.Module):
    """Flattened-connectivity MLP encoder (V4 tri-modal conn branch)."""

    def __init__(self, in_features: int = 459, hidden_dim: int = 128,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.mlp = MLP(in_features, (256, hidden_dim), dropout, norm="batch",
                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x.reshape(x.shape[0], -1))


def _conv_stack_mean(blocks, x: torch.Tensor) -> torch.Tensor:
    """ConvBNBlocks with a time max-pool between each pair, then the mean
    over time."""
    for i, block in enumerate(blocks):
        x = block(max_pool_time(x, 2) if i else x)
    return x.mean(dim=1)


class _LiteEncoder(nn.Module):
    """Two ConvBNBlocks around a max-pool, mean over time, projection,
    GELU, dropout (the V4-Lite encoders)."""

    def __init__(self, in_channels: int, widths, kernels, hidden_dim: int,
                 dropout: float, device=None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = ConvBNBlock(in_channels, widths, kernels[0], dropout,
                                 device)
        self.conv2 = ConvBNBlock(widths, hidden_dim, kernels[1], dropout,
                                 device)
        self.proj = Dense(hidden_dim, hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_stack_mean((self.conv1, self.conv2), x)
        return F.dropout(gelu(self.proj(x)), self.dropout, self.training)


class LiteERPEncoder(_LiteEncoder):
    """Transformer-free small ERP encoder (V4-Lite): Conv(7, 48), pool,
    Conv(5, hidden)."""

    def __init__(self, in_channels: int = 18, hidden_dim: int = 96,
                 dropout: float = 0.4, device=None):
        super().__init__(in_channels, 48, (7, 5), hidden_dim, dropout, device)


class LitePowerEncoder(_LiteEncoder):
    """Single-scale small power encoder (V4-Lite): Conv(5, 64), pool,
    Conv(3, hidden)."""

    def __init__(self, in_channels: int = 75, hidden_dim: int = 96,
                 dropout: float = 0.4, device=None):
        super().__init__(in_channels, 64, (5, 3), hidden_dim, dropout, device)


class AttnConnEncoder(nn.Module):
    """Connectivity encoder with feature attention (V4-Lite conn branch):
    256→128 projections, a tanh→sigmoid per-feature gate, output
    projection."""

    def __init__(self, in_features: int = 459, hidden_dim: int = 96,
                 dropout: float = 0.4, device=None):
        super().__init__()
        self.proj1 = MLP(in_features, (256,), dropout, norm="batch",
                         device=device)
        self.proj2 = MLP(256, (128,), dropout, norm="batch", device=device)
        self.attn1 = Dense(128, 64, device=device)
        self.attn2 = Dense(64, 128, device=device)
        self.out = MLP(128, (hidden_dim,), dropout, norm="batch",
                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj2(self.proj1(x.reshape(x.shape[0], -1)))
        gate = torch.sigmoid(self.attn2(torch.tanh(self.attn1(x))))
        return self.out(x * gate)


class GraphConnEncoder(nn.Module):
    """Batched dense masked graph attention over the connectivity graph:
    node i's features are its rows of the M matrices, edges are the pairs
    whose connectivity exceeds ``threshold`` in any metric (plus self
    loops), two GAT layers, a mean over nodes and a projection.

    Input: (B, N, N, M) stacked matrices or (B, N, N)."""

    def __init__(self, n_nodes: int = 18, n_metrics: int = 3,
                 hidden_dim: int = 128, num_heads: int = 4,
                 threshold: float = 0.5, dropout: float = 0.3, device=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide num_heads")
        self.num_heads = num_heads
        self.threshold = threshold
        self.dropout = dropout
        self.embed = Dense(n_metrics * n_nodes, hidden_dim, device=device)
        for layer in range(2):
            self.add_module(f"W_{layer}", Dense(hidden_dim, hidden_dim,
                                                bias=False, device=device))
            for side in ("src", "dst"):
                self.add_module(f"a_{side}_{layer}", Dense(
                    hidden_dim, num_heads, bias=False, device=device))
        self.proj = Dense(hidden_dim, hidden_dim, device=device)

    def forward(self, conn: torch.Tensor) -> torch.Tensor:
        if conn.dim() == 3:
            conn = conn[..., None]
        B, N, _, M = conn.shape
        adj = (conn > self.threshold).any(dim=-1)
        adj = adj | torch.eye(N, dtype=torch.bool, device=conn.device)
        # node features: each node's row of every metric, metric-major
        h = self.embed(conn.permute(0, 1, 3, 2).reshape(B, N, M * N))
        for layer in range(2):
            hw = getattr(self, f"W_{layer}")(h)                     # (B, N, D)
            a_src = getattr(self, f"a_src_{layer}")(hw)             # (B, N, H)
            a_dst = getattr(self, f"a_dst_{layer}")(hw)
            scores = F.leaky_relu(a_src[:, :, None] + a_dst[:, None], 0.2)
            scores = torch.where(adj[..., None], scores,
                                 torch.finfo(scores.dtype).min)
            alpha = F.dropout(softmax(scores, dim=2), self.dropout,
                              self.training)                         # (B,N,N,H)
            hd = hw.reshape(B, N, self.num_heads, -1)
            msg = torch.einsum("bijh,bjhd->bihd", alpha, hd)
            h = F.elu(msg.reshape(B, N, -1))
        g = gelu(self.proj(h.mean(dim=1)))
        return F.dropout(g, self.dropout, self.training)


class ERPEncoderV3(nn.Module):
    """V3 baseline ERP conv encoder: Conv(7, 64), pool, Conv(5, 128), pool,
    Conv(3, hidden), mean over time."""

    def __init__(self, in_channels: int = 18, hidden_dim: int = 64,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.conv1 = ConvBNBlock(in_channels, 64, 7, dropout, device)
        self.conv2 = ConvBNBlock(64, 128, 5, dropout, device)
        self.conv3 = ConvBNBlock(128, hidden_dim, 3, dropout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_stack_mean((self.conv1, self.conv2, self.conv3), x)


class PowerEncoderV3(nn.Module):
    """V3 baseline power conv encoder: Conv(5, 64), pool, Conv(3, 128),
    pool, Conv(3, hidden), mean over time."""

    def __init__(self, in_channels: int = 75, hidden_dim: int = 64,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.conv1 = ConvBNBlock(in_channels, 64, 5, dropout, device)
        self.conv2 = ConvBNBlock(64, 128, 3, dropout, device)
        self.conv3 = ConvBNBlock(128, hidden_dim, 3, dropout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_stack_mean((self.conv1, self.conv2, self.conv3), x)
