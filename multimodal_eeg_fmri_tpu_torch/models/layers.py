"""Shared model building blocks (PyTorch).

Counterpart of ``multimodal_eeg_fmri_tpu/models/layers.py``. Temporal
tensors are channels-last ``(batch, time, features)`` at every public
boundary, as in the JAX package. Submodule and parameter names follow the
flax names so that ``convert.load_flax_variables`` maps them one to one.
Training mode is the module's ``self.training`` flag (the JAX ``train=``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# exact (erf) GELU, as the JAX package uses
gelu = F.gelu


def sinusoidal_position_encoding(length: int, d_model: int, device=None,
                                 dtype=torch.float32) -> torch.Tensor:
    """(length, d_model) sinusoidal table, computed in f32."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = torch.zeros(length, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)[:, : (d_model + 1) // 2]
    pe[:, 1::2] = torch.cos(angles)[:, : d_model // 2]
    return pe.to(dtype)


def model_device(device) -> torch.device:
    """The device a public model builds on. The port's models default to
    the card; without one that default raises instead of building on the
    CPU, which a caller must ask for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's models build on the GPU by default; "
            "pass device='cpu' to build on the CPU")
    return device


class BatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm`` with its defaults, on (B, C) or (B, C, T).

    Training mode normalises with the batch mean and the biased variance
    over every axis but the features, computed as flax does
    (E[x²] − E[x]², clipped at 0), with ε = 1e-5, and updates
    ``running = 0.99·running + 0.01·batch`` for both mean and variance.
    (``nn.BatchNorm1d`` would put the unbiased variance into
    ``running_var``.) Eval mode is ``nn.BatchNorm1d``'s, on the running
    statistics. The buffer names are torch's, so that
    ``convert.load_flax_variables`` maps ``batch_stats`` one to one."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        mean = xf.mean(axes)
        var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(0.01 * mean)
            self.running_var.mul_(0.99).add_(0.01 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def batch_norm(d: int, device=None) -> BatchNorm:
    """The port's BatchNorm (flax's defaults and training-mode update)."""
    return BatchNorm(d, device=device)


class PositionalEncoding(nn.Module):
    """Add the sinusoidal table along time, then dropout."""

    def __init__(self, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = sinusoidal_position_encoding(x.shape[1], self.d_model, x.device,
                                          x.dtype)
        return F.dropout(x + pe[None], self.dropout, self.training)


class MultiHeadAttention(nn.Module):
    """Multi-head attention returning (output, head-averaged probabilities).

    ``attn_impl``: "auto" sends unmasked attention over keys at least
    ``flash_min_len`` long (and without probability dropout in training) to
    ``ops.attention.flash_attention``; "einsum" and "flash" force a route.
    The probabilities are None on the flash route. "ring" and "ring_local"
    are not ported yet."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 flash_min_len: int = 256, attn_impl: str = "auto",
                 flash_compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide num_heads")
        if attn_impl not in ("auto", "einsum", "flash", "ring", "ring_local"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout = dropout
        self.flash_min_len = flash_min_len
        self.attn_impl = attn_impl
        self.flash_compute_dtype = flash_compute_dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(d_model, d_model, device=device))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, Tq, d_model = query.shape
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).view(B, Tq, *heads)
        k = self.k_proj(key).view(B, key.shape[1], *heads)
        v = self.v_proj(value).view(B, value.shape[1], *heads)

        impl = self.attn_impl
        if impl == "auto":
            impl = "flash" if (
                mask is None
                and key.shape[1] >= self.flash_min_len
                and (self.dropout == 0.0 or not self.training)
            ) else "einsum"
        elif impl in ("flash", "ring", "ring_local"):
            if mask is not None:
                raise ValueError(
                    f"attn_impl={impl!r} does not support an attention "
                    "mask — use 'einsum' (or 'auto')")
            if self.dropout > 0.0 and self.training:
                raise ValueError(
                    f"attn_impl={impl!r} cannot apply attention-probability "
                    "dropout; set dropout=0.0 on the attention module (the "
                    "block's residual dropout is unaffected) or use "
                    "'einsum'/'auto'")
        if impl in ("ring", "ring_local"):
            raise NotImplementedError(
                f"attn_impl={impl!r} is not ported yet (ROADMAP.md, queue A "
                "item 8: parallel axes on torch.distributed)")
        if impl == "flash":
            from multimodal_eeg_fmri_tpu_torch.ops.attention import (
                flash_attention,
            )

            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                compute_dtype=self.flash_compute_dtype).transpose(1, 2)
            mean_probs = None
        else:
            scale = 1.0 / math.sqrt(self.head_dim)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            if mask is not None:
                logits = torch.where(mask, logits,
                                     torch.finfo(logits.dtype).min)
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            probs = F.dropout(probs, self.dropout, self.training)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
            # torch returns attention averaged over heads
            mean_probs = probs.mean(dim=1)
        out = self.out_proj(out.reshape(B, Tq, d_model))
        return out, mean_probs


class TransformerBlock(nn.Module):
    """Pre-norm block: LN → MHA → residual; LN → GELU FFN → residual."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 dim_feedforward: int = 0, dropout: float = 0.1,
                 num_experts: int = 0, device=None):
        super().__init__()
        if num_experts > 0:
            raise NotImplementedError(
                "the Mixture-of-Experts FFN is not ported yet (ROADMAP.md, "
                "queue A item 6: ops/moe.py:MoEFFN)")
        ff = dim_feedforward or 4 * d_model
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads, dropout,
                                       device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ffn1 = nn.Linear(d_model, ff, device=device)
        self.ffn2 = nn.Linear(ff, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        y, _ = self.attn(y, y, y)
        x = x + F.dropout(y, self.dropout, self.training)
        y = gelu(self.ffn1(self.norm2(x)))
        y = self.ffn2(F.dropout(y, self.dropout, self.training))
        return x + F.dropout(y, self.dropout, self.training)


class DropPath(nn.Module):
    """Stochastic depth per sample."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            keep)
        return x / keep * mask


class MLP(nn.Module):
    """Dense → norm → act → dropout stack; ``norm`` ∈ {"batch", "layer",
    "none"}."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0, norm: str = "batch",
                 activation: Callable = gelu, final_activation: bool = True,
                 device=None):
        super().__init__()
        if norm not in ("batch", "layer", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.dropout = dropout
        self.activation = activation
        self.n = len(features)
        self.final_activation = final_activation
        self.norm = norm
        d = in_features
        for i, feat in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(d, feat, device=device))
            if i < self.n - 1 or final_activation:
                if norm == "batch":
                    self.add_module(f"bn_{i}", batch_norm(feat, device))
                elif norm == "layer":
                    self.add_module(f"ln_{i}", nn.LayerNorm(
                        feat, eps=1e-5, device=device))
            d = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.final_activation:
                if self.norm == "batch":
                    x = getattr(self, f"bn_{i}")(x)
                elif self.norm == "layer":
                    x = getattr(self, f"ln_{i}")(x)
                x = self.activation(x)
                x = F.dropout(x, self.dropout, self.training)
        return x


class ClassifierHead(nn.Module):
    """Hidden layers with norm/GELU/dropout, then a final Linear."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 num_classes: int, dropout: float = 0.3, norm: str = "batch",
                 activation: Callable = gelu, device=None):
        super().__init__()
        self.hidden = MLP(in_features, tuple(hidden), dropout, norm,
                          activation, device=device)
        self.out = nn.Linear(hidden[-1] if hidden else in_features,
                             num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.hidden(x))
