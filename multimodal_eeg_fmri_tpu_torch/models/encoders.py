"""Modality encoders (PyTorch, channels-last ``(B, T, C)``).

Counterpart of the V4 encoders of ``multimodal_eeg_fmri_tpu/models/
encoders.py``. Flax infers input widths at the first call; here they are
constructor arguments, with the serving shapes' widths as defaults.
"""

from __future__ import annotations

import math

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
    """CNN + temporal-transformer ERP encoder (V4 'enhanced')."""

    def __init__(self, in_channels: int = 18, hidden_dim: int = 128,
                 num_transformer_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = ConvBNBlock(in_channels, 64, 7, dropout, device)
        self.conv2 = ConvBNBlock(64, 128, 5, device=device)
        self.conv3 = ConvBNBlock(128, hidden_dim, 3, dropout, device)
        self.pos = PositionalEncoding(hidden_dim, dropout)
        self.n_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            self.add_module(f"transformer_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout, device=device))
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
    """Multi-scale CNN + transformer power-spectrum encoder (V4)."""

    def __init__(self, in_channels: int = 75, hidden_dim: int = 128,
                 num_transformer_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.dropout = dropout
        self.multiscale = MultiScaleConv(in_channels, 64, device)
        self.fuse = ConvBNBlock(192, hidden_dim, 1, dropout, device)
        self.pos = PositionalEncoding(hidden_dim, dropout)
        self.n_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            self.add_module(f"transformer_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout, device=device))
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
