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
Mixture-of-Experts blocks on the ring route the tokens of the whole
sequence (``ops.moe``). ``expert_axis`` shards each block's experts over
that axis of ``mesh`` once ``parallel.expert`` lays the model out (expert
parallelism; the batch shards over the mesh's ``data`` axis).

``PipelinedLongContextClassifier`` pipelines the depth over a stage axis
(``parallel.pipeline``); with ``seq_axis`` its stages' attention runs the
ring body over that axis as well.
"""

from __future__ import annotations

import contextlib
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
        device = model_device(device)
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.patch = patch
        self.remat = remat
        # the mesh the time axis shards over (the ring route) or the
        # experts (expert parallelism)
        self.mesh = mesh if attn_impl == "ring" or expert_axis else None
        self.seq_axis = seq_axis if self.mesh is not None and (
            attn_impl == "ring") else None
        self.embed = Dense(patch * in_channels, hidden_dim, device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                hidden_dim, num_heads, dropout=dropout,
                num_experts=num_experts, device=device, attn_impl=attn_impl,
                moe_top_k=moe_top_k, flash_compute_dtype=flash_compute_dtype,
                mesh=mesh, seq_axis=seq_axis, head_axis=head_axis,
                ring_chunk_impl=ring_chunk_impl, expert_axis=expert_axis))
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
        offset = (0 if self.seq_axis is None
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
        if self.seq_axis is None:
            pooled = self.final_ln(x).mean(dim=1)
        else:
            n = self.mesh.shape[self.seq_axis]
            pooled = psum(self.final_ln(x).sum(dim=1), self.seq_axis,
                          self.mesh) / (n * tokens)
        feat = gelu(self.pool_proj(pooled))
        return ModelOutput(self.classifier(feat), feat, None, None)


@contextlib.contextmanager
def _seeded(device: torch.device, seed: int):
    """The default generator of ``device`` seeded with ``seed`` inside the
    block and restored after it (dropout draws from it)."""
    if device.type == "cuda":
        with torch.random.fork_rng(devices=[device.index or 0],
                                   device_type="cuda"):
            torch.cuda.manual_seed(seed)
            yield
    else:
        with torch.random.fork_rng(devices=[]):
            torch.random.default_generator.manual_seed(seed)
            yield


class PipelinedLongContextClassifier(nn.Module):
    """Long-context classifier with the transformer depth pipelined over the
    ``stage_axis`` of ``mesh`` (``parallel.pipeline.pipeline_apply``, GPipe
    over ``n_micro`` microbatches, default the stage count). Counterpart of
    ``multimodal_eeg_fmri_tpu.models.long_context.
    PipelinedLongContextClassifier``, with its constructor and defaults.

    The blocks are the JAX package's stacked ``blocks`` (one a layer):
    ``mesh=None`` is the sequential twin, which holds all ``num_layers``
    (``blocks.0`` … ``blocks.{L-1}``); on a mesh, ``num_layers`` must equal
    the stage axis's size, and each rank builds only its own stage's block
    (``blocks.{stage}``, the twin's name for it). The embedding, the final
    LayerNorm, ``pool_proj`` and the head are replicated. It trains through
    ``train.fit`` unchanged, which reduces each block's gradient over the
    other axes only. ``full_state_dict()`` gathers the twin's state dict
    (collective), for checkpoints and EMA; ``load_state_dict`` of a rank
    takes its local one (``parallel.layout.local_tree`` cuts the twin's).

    With ``seq_axis`` on a (stage, seq) mesh, each rank's ``erp`` is its
    time slice (``parallel.input.shard_sequence``) and each stage's
    attention runs the ring body over ``seq_axis`` (``attn_impl=
    "ring_local"``, the ring's size fixed from the mesh, each hop's chunk
    by ``ring_chunk_impl``, a port option); dropout there raises, as in the
    JAX package.

    Dropout: the JAX package derives each (stage, microbatch)'s key by
    ``fold_in``, which torch's generators cannot reproduce. The port's rule:
    a training forward draws one base seed from the default generator of
    the model's device, and stage s runs microbatch m with that device's
    generator seeded ``parallel.pipeline.stage_seed(base, s, m)``; the twin
    splits the batch into the same microbatches and seeds the same way, so
    the pipelined run equals the twin's."""

    def __init__(self, hidden_dim: int = 64, num_classes: int = 2,
                 num_layers: Optional[int] = None, num_heads: int = 4,
                 patch: int = 1, mesh=None, stage_axis: str = "stage",
                 n_micro: Optional[int] = None,
                 seq_axis: Optional[str] = None, dropout: float = 0.0,
                 ring_chunk_impl: str = "einsum", in_channels: int = 18,
                 device="cuda"):
        super().__init__()
        if dropout > 0 and seq_axis is not None:
            raise ValueError(
                "PipelinedLongContextClassifier: dropout is not supported "
                "on the composed (stage, seq) mesh — masks over a "
                "time-sharded activation cannot match an unsharded twin. "
                "Use weight decay (TrainConfig.weight_decay) there, or "
                "drop seq_axis.")
        if mesh is not None:
            n_stages = mesh.shape[stage_axis]
            if num_layers is None:
                num_layers = n_stages
            if num_layers != n_stages:
                raise ValueError(
                    f"num_layers={num_layers} must equal the mesh's "
                    f"{stage_axis} axis ({n_stages}) — homogeneous pipeline")
        elif num_layers is None:
            num_layers = 2
        device = model_device(device)
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.patch = patch
        self.mesh = mesh
        self.stage_axis = stage_axis
        self.n_micro = n_micro
        self.seq_axis = seq_axis if mesh is not None else None
        self.dropout = dropout
        if self.seq_axis is not None:
            block_kw = dict(dropout=0.0, attn_impl="ring_local",
                            seq_axis=seq_axis,
                            ring_size=mesh.shape[seq_axis], mesh=mesh,
                            ring_chunk_impl=ring_chunk_impl)
        else:
            block_kw = dict(dropout=dropout)
        owned = (range(num_layers) if mesh is None
                 else [mesh.axis_index(stage_axis)])
        self.embed = Dense(patch * in_channels, hidden_dim, device=device)
        self.blocks = nn.ModuleDict({
            str(i): TransformerBlock(hidden_dim, num_heads, device=device,
                                     **block_kw) for i in owned})
        self.final_ln = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.pool_proj = Dense(hidden_dim, hidden_dim, device=device)
        self.head = ClassifierHead(hidden_dim, (hidden_dim // 2,),
                                   num_classes, 0.0, norm="layer",
                                   device=device)
        # a stage's block differs from rank to rank along the stage axis
        self.stage_param_axes = ({} if mesh is None else {
            n: (stage_axis,) for n, _ in self.named_parameters()
            if n.startswith("blocks.")})

    def forward(self, *, erp: torch.Tensor,
                pw: Optional[torch.Tensor] = None,
                conn: Optional[torch.Tensor] = None) -> ModelOutput:
        B, T, C = erp.shape
        if T % self.patch:
            raise ValueError(f"T={T} not divisible by patch={self.patch}")
        x = self.embed(erp.reshape(B, T // self.patch, self.patch * C))
        tokens = x.shape[1]
        offset = (0 if self.seq_axis is None
                  else self.mesh.axis_index(self.seq_axis) * tokens)
        x = x + sinusoidal_position_encoding(
            tokens, self.hidden_dim, x.device, x.dtype, offset)[None]
        base = None
        if self.training and self.dropout > 0:
            base = int(torch.randint(1 << 62, (1,), device=x.device).item())
        if self.mesh is not None:
            from multimodal_eeg_fmri_tpu_torch.parallel.pipeline import (
                pipeline_apply,
            )

            block = self.blocks[str(self.mesh.axis_index(self.stage_axis))]
            x = pipeline_apply(block, x, self._apply, self.mesh,
                               self.stage_axis, self.n_micro, base)
        elif base is not None:
            x = self._twin_dropout(x, base)
        else:
            for i in range(self.num_layers):
                x = self.blocks[str(i)](x)
        if self.seq_axis is None:
            pooled = self.final_ln(x).mean(dim=1)
        else:
            n = self.mesh.shape[self.seq_axis]
            pooled = psum(self.final_ln(x).sum(dim=1), self.seq_axis,
                          self.mesh) / (n * tokens)
        feat = gelu(self.pool_proj(pooled))
        return ModelOutput(self.head(feat), feat, None, None)

    @staticmethod
    def _apply(block: nn.Module, h: torch.Tensor,
               seed: Optional[int] = None) -> torch.Tensor:
        if seed is None:
            return block(h)
        with _seeded(h.device, seed):
            return block(h)

    def _twin_dropout(self, x: torch.Tensor, base: int) -> torch.Tensor:
        """The sequential twin with dropout: the pipeline's microbatches and
        seeds, stage after stage."""
        from multimodal_eeg_fmri_tpu_torch.parallel.pipeline import (
            stage_seed,
        )

        n_micro = self.n_micro or self.num_layers
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"n_micro={n_micro}")
        xs = list(x.chunk(n_micro))
        for i in range(self.num_layers):
            xs = [self._apply(self.blocks[str(i)], h,
                              stage_seed(base, i, m))
                  for m, h in enumerate(xs)]
        return torch.cat(xs)

    def _full_tree(self, tree):
        """``tree`` (by state-dict name) with every rank's block: the
        twin's names, gathered over the stage axis (collective)."""
        from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
            all_gather,
        )

        if self.mesh is None:
            return dict(tree)
        mine = f"blocks.{self.mesh.axis_index(self.stage_axis)}."
        out = {k: v for k, v in tree.items() if not k.startswith("blocks.")}
        for k in sorted(tree):
            if k.startswith(mine):
                rest = k[len(mine):]
                stacked = all_gather(tree[k][None], self.stage_axis, 0,
                                     self.mesh)
                for i in range(self.num_layers):
                    out[f"blocks.{i}.{rest}"] = stacked[i]
        return out

    def _local_tree(self, tree):
        """``tree`` keeping only this rank's block (a local tree passes)."""
        if self.mesh is None:
            return dict(tree)
        mine = f"blocks.{self.mesh.axis_index(self.stage_axis)}."
        return {k: v for k, v in tree.items()
                if not k.startswith("blocks.") or k.startswith(mine)}

    def full_state_dict(self):
        """The twin's state dict, gathered over the stage axis on every
        rank (collective)."""
        return self._full_tree(self.state_dict())
