"""Long-context sequence classifier (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/models/long_context.py:LongContextClassifier``.

A transformer over one long raw recording ``erp`` (B, T, C): ``patch``
frames per token, a Dense embedding, the sinusoidal table, ``num_layers``
pre-norm blocks (each with a Mixture-of-Experts FFN when ``num_experts``
> 0), a final LayerNorm, the mean over tokens, ``pool_proj`` + GELU and a
LayerNorm classifier head. At dropout 0 (or in eval mode) and 256 tokens
or more, the "auto" rule sends every block's attention to the flash
kernels (K1 forward, K2 and K3 backward).

``remat=True`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, non-reentrant) instead of keeping them: a
training forward and backward runs K1 twice a block. The block's MoE aux
loss leaves the checkpointed function as an output, so the recomputation
adds none.

``attn_impl="ring"`` with a ``mesh`` (``parallel.mesh.Mesh``) trains with
the time axis sharded over ``seq_axis``: each rank's ``erp`` is its time
slice, (B, T/n, C) (``parallel.input.shard_sequence``), and every rank ends
with the whole batch's logits. Each block's attention is ring attention
(``ops.ring_attention``; with ``ring_chunk_impl="flash"`` every hop runs the
kernels), the sinusoidal table starts at the slice's global offset, and the
mean over tokens is a ``psum`` of the ranks' sums over the seq axis. With
``head_axis`` each rank runs the ring over its slice of the heads and the
heads are all-gathered before ``out_proj``. The parameters are the
single-device model's (one state dict, one set of flax variables), the same
on every rank; ``train.fit`` averages their gradients over the mesh.
Mixture-of-Experts blocks route the tokens each rank holds, so they do not
combine with the ring, and ``expert_axis`` (expert parallelism) raises;
both wait for parameter sharding (ROADMAP.md, queue A item 7b).
``PipelinedLongContextClassifier`` waits for the pipeline (queue A item
7a).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.models.layers import (
    ClassifierHead,
    Dense,
    TransformerBlock,
    gelu,
    model_device,
    sinusoidal_position_encoding,
)
from multimodal_eeg_fmri_tpu_torch.ops.moe import (
    add_aux_loss,
    collect_aux_losses,
    total_aux_loss,
)
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import psum


def _block_and_aux(block: nn.Module, x: torch.Tensor):
    """(block(x), the sum of the aux losses its MoE layers leave, or
    None): the function ``remat`` checkpoints."""
    with collect_aux_losses() as sink:
        y = block(x)
    return y, total_aux_loss(sink)


class LongContextClassifier(nn.Module):
    """Transformer classifier over one long raw sequence (key ``erp``;
    ``pw`` and ``conn`` are accepted and ignored). ``in_channels`` is C,
    which flax infers (default: the reference EEG's 18 channels). Builds
    on the GPU unless ``device`` says otherwise."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 2,
                 num_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.0, patch: int = 1,
                 attn_impl: str = "auto", mesh=None, seq_axis: str = "seq",
                 head_axis: Optional[str] = None, num_experts: int = 0,
                 moe_top_k: int = 1, expert_axis: Optional[str] = None,
                 flash_compute_dtype: torch.dtype = torch.float32,
                 ring_chunk_impl: str = "einsum", remat: bool = False,
                 in_channels: int = 18, device="cuda"):
        super().__init__()
        if expert_axis is not None:
            raise NotImplementedError(
                "LongContextClassifier: expert_axis is not ported yet "
                "(ROADMAP.md, queue A item 7b: parameter sharding)")
        if attn_impl == "ring" and num_experts > 0:
            raise NotImplementedError(
                "LongContextClassifier: Mixture-of-Experts blocks with "
                "attn_impl='ring' are not ported yet (ROADMAP.md, queue A "
                "item 7b: parameter sharding)")
        device = model_device(device)
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.patch = patch
        self.remat = remat
        # the mesh the time axis shards over, on the ring route only
        self.mesh = mesh if attn_impl == "ring" else None
        self.seq_axis = seq_axis
        self.embed = Dense(patch * in_channels, hidden_dim, device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout,
                num_experts=num_experts, device=device, attn_impl=attn_impl,
                moe_top_k=moe_top_k, flash_compute_dtype=flash_compute_dtype,
                mesh=mesh, seq_axis=seq_axis, head_axis=head_axis,
                ring_chunk_impl=ring_chunk_impl))
        self.final_ln = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.pool_proj = Dense(hidden_dim, hidden_dim, device=device)
        self.classifier = ClassifierHead(hidden_dim, (hidden_dim // 2,),
                                         num_classes, dropout, norm="layer",
                                         device=device)

    def forward(self, *, erp: torch.Tensor,
                pw: Optional[torch.Tensor] = None,
                conn: Optional[torch.Tensor] = None) -> ModelOutput:
        B, T, C = erp.shape
        if T % self.patch:
            raise ValueError(f"T={T} not divisible by patch={self.patch}")
        x = self.embed(erp.reshape(B, T // self.patch, self.patch * C))
        tokens = x.shape[1]
        offset = (0 if self.mesh is None
                  else self.mesh.axis_index(self.seq_axis) * tokens)
        x = x + sinusoidal_position_encoding(
            tokens, self.hidden_dim, x.device, x.dtype, offset)[None]
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            if self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(_block_and_aux, block, x,
                                    use_reentrant=False)
                add_aux_loss(aux)
            else:
                x = block(x)
        if self.mesh is None:
            pooled = self.final_ln(x).mean(dim=1)
        else:
            n = self.mesh.shape[self.seq_axis]
            pooled = psum(self.final_ln(x).sum(dim=1), self.seq_axis,
                          self.mesh) / (n * tokens)
        feat = gelu(self.pool_proj(pooled))
        return ModelOutput(self.classifier(feat), feat, None, None)
