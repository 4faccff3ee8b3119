"""Shared model building blocks (PyTorch).

Counterpart of ``multimodal_eeg_fmri_tpu/models/layers.py``. Temporal
tensors are channels-last ``(batch, time, features)`` at every public
boundary, as in the JAX package. Submodule and parameter names follow the
flax names so that ``convert.load_flax_variables`` maps them one to one.
Training mode is the module's ``self.training`` flag (the JAX ``train=``).

The layers compute in their inputs' dtype with the ops flax uses, so that a
bf16 forward rounds where the JAX package's does: ``Dense`` and ``Conv1d``
add the bias after the product, and ``gelu`` and ``softmax`` are jax.nn's
formulas, one rounding per op (torch's fused kernels round once).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device
from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import psum
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import current_batch_axis


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` computes it:
    0.5·x·erfc(−x·√½), with √½ rounded to x's dtype."""
    sqrt_half = torch.tensor(math.sqrt(0.5)).to(x.dtype).item()
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x − max) / Σ exp(x − max), in x's dtype."""
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


class Dense(nn.Linear):
    """``nn.Linear`` as flax's ``Dense`` computes it: the product, then the
    bias as an op of its own. A row-parallel projection of tensor
    parallelism (``reduce_axis`` = (mesh, axis), set by
    ``parallel.tensor``) sums its product over the axis before the bias."""

    reduce_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        if self.reduce_axis is not None:
            mesh, axis = self.reduce_axis
            y = psum(y, axis, mesh)
        return y if self.bias is None else y + self.bias


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on (B, C, T) with the bias added after the
    convolution, as flax's ``Conv`` adds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight, None)
        return y if self.bias is None else y + self.bias[:, None]


def sinusoidal_position_encoding(length: int, d_model: int, device=None,
                                 dtype=torch.float32,
                                 offset: int = 0) -> torch.Tensor:
    """(length, d_model) sinusoidal table, computed in f32; ``offset`` is
    the position of its first row (a rank's time slice of a longer table,
    whose rows it equals)."""
    position = torch.arange(offset, offset + length, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = torch.zeros(length, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)[:, : (d_model + 1) // 2]
    pe[:, 1::2] = torch.cos(angles)[:, : d_model // 2]
    return pe.to(dtype)


class BatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm`` with its defaults, on (B, C) or (B, C, T).

    Training mode normalises with the batch mean and the biased variance
    over every axis but the features, computed as flax does
    (E[x²] − E[x]², clipped at 0), with ε = 1e-5, and updates
    ``running = 0.99·running + 0.01·batch`` for both mean and variance.
    (``nn.BatchNorm1d`` would put the unbiased variance into
    ``running_var``.) Eval mode is ``nn.BatchNorm1d``'s, on the running
    statistics. The buffer names are torch's, so that
    ``convert.load_flax_variables`` maps ``batch_stats`` one to one.

    Inside ``parallel.mesh.batch_sharded`` (the batch's rows sharded over a
    mesh axis) the statistics are the whole batch's: the sums of x and x²
    are summed over the axis, as GSPMD reduces them."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        sharded = current_batch_axis()
        if sharded is None:
            mean = xf.mean(axes)
            sq = (xf * xf).mean(axes)
        else:
            mesh, axis = sharded
            count = (x.numel() // x.shape[1]) * mesh.shape[axis]
            sums = psum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]),
                        axis, mesh) / count
            mean, sq = sums[0], sums[1]
        var = (sq - mean * mean).clamp_min(0.0)
        # the running statistics take detached values, so autograd records
        # nothing, and a program that torch.export traces holds the update
        # as plain in-place ops (it cannot serialise a no_grad block that
        # returns nothing)
        self.running_mean.mul_(0.99).add_(0.01 * mean.detach())
        self.running_var.mul_(0.99).add_(0.01 * var.detach())
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
    The sequence-parallel routes take this rank's time slice of the
    sequence: "ring" runs ``ops.ring_attention`` over ``seq_axis`` of
    ``mesh``, and with ``head_axis`` over this rank's slice of the heads,
    whose outputs are all-gathered over ``head_axis`` before ``out_proj``;
    "ring_local" runs the ring body over ``seq_axis`` of ``mesh`` or of the
    active mesh (``with mesh:``), whose size must be ``ring_size``.
    ``ring_chunk_impl`` is each hop's attention ("einsum" or "flash", the
    kernels). The probabilities are None on the flash and ring routes.

    Under tensor parallelism (``parallel.tensor``) the projections hold this
    rank's slice of the heads: the attention runs on those heads, and
    ``out_proj`` sums its product over the axis; ``head_reduce`` (mesh,
    axis) averages the probabilities over every head."""

    head_reduce = None

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 flash_min_len: int = 256, attn_impl: str = "auto",
                 flash_compute_dtype: torch.dtype = torch.float32,
                 device=None, *, mesh=None, seq_axis: str = "seq",
                 head_axis: Optional[str] = None,
                 ring_size: Optional[int] = None,
                 ring_chunk_impl: str = "einsum"):
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
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.head_axis = head_axis
        self.ring_size = ring_size
        self.ring_chunk_impl = ring_chunk_impl
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d_model, d_model, device=device))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, Tq, _ = query.shape
        q = self.q_proj(query)
        # the heads this rank holds (a slice of them under tensor
        # parallelism)
        heads = (q.shape[-1] // self.head_dim, self.head_dim)
        q = q.view(B, Tq, *heads)
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
            out = self._ring(impl, q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
            mean_probs = None
        elif impl == "flash":
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
            probs = softmax(logits.float()).to(q.dtype)
            probs = F.dropout(probs, self.dropout, self.training)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
            # torch returns attention averaged over heads
            if self.head_reduce is None:
                mean_probs = probs.mean(dim=1)
            else:
                mesh, axis = self.head_reduce
                mean_probs = psum(probs.sum(dim=1), axis,
                                  mesh) / self.num_heads
        out = self.out_proj(out.reshape(B, Tq, heads[0] * heads[1]))
        return out, mean_probs

    def _ring(self, impl: str, q, k, v) -> torch.Tensor:
        """The ring routes on (B, H, T_local, hd) projections."""
        from multimodal_eeg_fmri_tpu_torch.ops.ring_attention import (
            ring_attention,
            ring_attention_local,
        )
        from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
            all_gather,
        )

        if impl == "ring_local":
            if self.ring_size is None:
                raise ValueError("attn_impl='ring_local' requires ring_size")
            return ring_attention_local(
                q, k, v, axis_name=self.seq_axis, axis_size=self.ring_size,
                compute_dtype=self.flash_compute_dtype,
                impl=self.ring_chunk_impl, mesh=self.mesh)
        if self.mesh is None:
            raise ValueError("attn_impl='ring' requires a mesh")
        heads = self.head_axis
        if heads is not None:
            m = self.mesh.shape[heads]
            if self.num_heads % m:
                raise ValueError(f"H={self.num_heads} not divisible by "
                                 f"{heads}={m}")
            h = self.num_heads // m
            j = self.mesh.axis_index(heads)
            q, k, v = (t[:, j * h:(j + 1) * h] for t in (q, k, v))
        out = ring_attention(q, k, v, self.mesh, axis=self.seq_axis,
                             head_axis=heads,
                             compute_dtype=self.flash_compute_dtype,
                             impl=self.ring_chunk_impl)
        if heads is not None:
            out = all_gather(out, heads, axis=1, mesh=self.mesh)
        return out


class TransformerBlock(nn.Module):
    """Pre-norm block: LN → MHA → residual; LN → FFN → residual. The FFN is
    GELU of width ``dim_feedforward`` (0: 4·d_model) with dropout inside,
    or with ``num_experts`` > 0 the Mixture-of-Experts FFN
    (``ops.moe.MoEFFN``, top-``moe_top_k`` routing), which has none.
    ``attn_impl``, ``flash_compute_dtype`` and the ring's ``mesh``,
    ``seq_axis``, ``head_axis``, ``ring_size`` and ``ring_chunk_impl`` go to
    the attention. ``mesh`` and ``expert_axis`` go to the MoE FFN (expert
    parallelism), and on the ring route (``attn_impl="ring"``) so does
    ``seq_axis``: the experts route the tokens of the whole sequence."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 dim_feedforward: int = 0, dropout: float = 0.1,
                 num_experts: int = 0, device=None, *,
                 attn_impl: str = "auto", moe_top_k: int = 1,
                 moe_capacity_factor: float = 2.0,
                 moe_aux_weight: float = 0.01,
                 flash_compute_dtype: torch.dtype = torch.float32,
                 mesh=None, seq_axis: str = "seq",
                 head_axis: Optional[str] = None,
                 ring_size: Optional[int] = None,
                 ring_chunk_impl: str = "einsum",
                 expert_axis: Optional[str] = None):
        super().__init__()
        ff = dim_feedforward or 4 * d_model
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.attn = MultiHeadAttention(
            d_model, num_heads, dropout, attn_impl=attn_impl,
            flash_compute_dtype=flash_compute_dtype, device=device,
            mesh=mesh, seq_axis=seq_axis, head_axis=head_axis,
            ring_size=ring_size, ring_chunk_impl=ring_chunk_impl)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        if num_experts > 0:
            self.moe = MoEFFN(d_model, num_experts, dim_feedforward,
                              moe_top_k, moe_capacity_factor, moe_aux_weight,
                              mesh=mesh, expert_axis=expert_axis,
                              seq_axis=seq_axis if attn_impl == "ring"
                              else None, device=device)
        else:
            self.ffn1 = Dense(d_model, ff, device=device)
            self.ffn2 = Dense(ff, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        y, _ = self.attn(y, y, y)
        x = x + F.dropout(y, self.dropout, self.training)
        y = self.norm2(x)
        if hasattr(self, "moe"):
            y = self.moe(y)
        else:
            y = gelu(self.ffn1(y))
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
            self.add_module(f"dense_{i}", Dense(d, feat, device=device))
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
    """Hidden layers with norm/GELU/dropout, then a final Dense."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 num_classes: int, dropout: float = 0.3, norm: str = "batch",
                 activation: Callable = gelu, device=None):
        super().__init__()
        self.hidden = MLP(in_features, tuple(hidden), dropout, norm,
                          activation, device=device)
        self.out = Dense(hidden[-1] if hidden else in_features,
                         num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.hidden(x))
