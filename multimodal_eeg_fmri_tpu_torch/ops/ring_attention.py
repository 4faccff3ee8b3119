"""Ring attention: sequence parallelism for the long-context path.
Counterpart of ``multimodal_eeg_fmri_tpu/ops/ring_attention.py``.

The time axis shards over a mesh axis of n ranks. Each rank holds its
(B, H, T/n, D) chunk of q, k and v; the K/V chunks travel round the ring by
``ppermute_shift`` (n − 1 hops; the JAX package's n-th rotation brings each
chunk home unused) while each rank folds every chunk it holds into a running
online-softmax state, so that after n chunks it holds the exact attention
of its queries over the whole sequence. The collectives' backward is their
transpose, so gradients flow back round the ring.

Two per-chunk implementations (``impl``):

- "einsum": ``_chunk_scores`` materialises the (T/n, T/n) score tile and the
  running (m, l, acc) merge rescales it;
- "flash": each hop is one ``flash_attention_lse`` call (on a CUDA tensor
  K1 forward, K2 and K3 backward, the hand-written kernels; on a CPU tensor
  their plain versions), and hops merge exactly through the logaddexp of
  their per-row lse. The merge differentiates through lse, so every hop's
  K2 and K3 get a nonzero lse cotangent folded into Δ.

The port is SPMD: ``ring_attention`` takes and returns this rank's shards,
as ``parallel.input.shard_sequence`` cuts them (which raises when T does not
divide the ring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from multimodal_eeg_fmri_tpu_torch.ops.attention import flash_attention_lse
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import ppermute_shift
from multimodal_eeg_fmri_tpu_torch.parallel.input import (
    SEQ_AXIS,
    shard_sequence,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import Mesh, resolve_mesh

__all__ = ["SEQ_AXIS", "ring_attention", "ring_attention_local",
           "shard_sequence"]

IMPLS = ("einsum", "flash")


def _chunk_scores(q, k, v, scale, compute_dtype=torch.float32):
    """Unnormalised attention of the local q over one K/V chunk: (o
    (B,H,Tq,D), m (B,H,Tq), l (B,H,Tq)) in f32. The two products take
    operands rounded to ``compute_dtype`` and sum in f32, as the JAX
    package's einsums with ``preferred_element_type=f32``."""
    def op(x):
        return x.to(compute_dtype).float()

    s = torch.einsum("bhqd,bhkd->bhqk", op(q), op(k)) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", op(p), op(v))
    return o, m, l


def ring_attention_local(q, k, v, axis_name: str, axis_size: int,
                         scale: Optional[float] = None,
                         compute_dtype=torch.float32, impl: str = "einsum",
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's body of the ring: q, k, v are its (B, H, T_local, D)
    chunks; the ring is ``axis_name`` of ``mesh`` (default: the active
    mesh), whose size must be ``axis_size``. Returns the attention output
    of the local queries in q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ring chunk impl {impl!r}; one of {IMPLS}")
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if impl == "flash" and abs(scale - 1.0 / math.sqrt(D)) > 1e-12:
        raise ValueError(
            "impl='flash' uses the kernel's fixed 1/sqrt(D) scale; a custom "
            "scale requires impl='einsum'")
    mesh = resolve_mesh(mesh)
    n = mesh.shape[axis_name]
    if n != axis_size:
        raise ValueError(f"ring_size={axis_size} but mesh axis {axis_name!r} "
                         f"holds {n} ranks")
    k_c, v_c = k, v
    for hop in range(n):
        if hop:
            k_c, v_c = ppermute_shift((k_c, v_c), axis_name, mesh=mesh)
        if impl == "flash":
            o_c, lse_c = flash_attention_lse(q, k_c, v_c, compute_dtype)
            o_c = o_c.float()
            if hop == 0:
                # the merge with the empty state (lse = −inf, acc = 0) is
                # exactly the first chunk's own result
                acc, lse = o_c, lse_c
                continue
            # exact two-way merge of normalised partials
            lse_new = torch.logaddexp(lse, lse_c)
            acc = (acc * torch.exp(lse - lse_new)[..., None]
                   + o_c * torch.exp(lse_c - lse_new)[..., None])
            lse = lse_new
        else:
            o_c, m_c, l_c = _chunk_scores(q, k_c, v_c, scale, compute_dtype)
            if hop == 0:
                acc, m, l = o_c, m_c, l_c
                continue
            m_new = torch.maximum(m, m_c)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_c - m_new)
            acc = acc * alpha[..., None] + o_c * beta[..., None]
            l = l * alpha + l_c * beta
            m = m_new
    if impl == "einsum":
        acc = acc / l.clamp_min(1e-30)[..., None]
    return acc.to(q.dtype)


def ring_attention(q, k, v, mesh: Mesh, axis: str = SEQ_AXIS,
                   head_axis: Optional[str] = None,
                   compute_dtype=torch.float32,
                   impl: str = "einsum") -> torch.Tensor:
    """Sequence-parallel attention of this rank's shards: q, k, v are its
    (B, H, T/n, D) blocks of the (B, H, T, D) arrays whose T shards over
    ``axis`` of ``mesh`` (``shard_sequence``); returns its block of the
    output. With ``head_axis`` the heads also shard over that axis (the
    blocks are (B, H/m, T/n, D)): heads are independent, so each rank runs
    the ring over its head slice with no further collective.
    Differentiable."""
    if head_axis is not None and head_axis not in mesh.shape:
        raise ValueError(f"no mesh axis {head_axis!r} in {mesh.axis_names}")
    return ring_attention_local(q, k, v, axis_name=axis,
                                axis_size=mesh.shape[axis],
                                compute_dtype=compute_dtype, impl=impl,
                                mesh=mesh)
