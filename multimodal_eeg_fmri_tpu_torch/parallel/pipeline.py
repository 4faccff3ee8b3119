"""Pipeline parallelism: GPipe's schedule over a ``stage`` mesh axis on
``torch.distributed``. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/pipeline.py``.

A stack of identical stages shards its depth over the stage axis: each
rank holds one stage (its weights never move) and microbatches hop from
stage to stage. The schedule is the JAX package's, ``n_micro + n_stages −
1`` ticks: at tick t stage 0 takes microbatch t, every stage applies its
own stage to what it holds, and the result hops to the next stage
(``collectives.ppermute_shift``, +1 around the stage ring); the last stage
collects microbatch t − (n_stages − 1), and a masked ``psum`` over the axis
hands the outputs to every rank. Autograd transposes the hops (a −1 shift
of the cotangents), which is the backward pipeline.

The port skips the bubble: a stage applies its stage only on the
``n_micro`` ticks that hold a microbatch, whose outputs the JAX package
keeps (it computes the others and discards them). So a rank runs its stage
``n_micro`` times a forward, and the kernels in it launch ``n_micro`` times
a forward and a backward. A bubble tick passes a zero-weighted copy of
what it received instead, so that every rank's hops form one chain: each
hop's backward is a collective, and the chain makes every rank run them in
the same order.

With a sequence axis beside the stage axis, each rank's input is its time
slice (the JAX package's ``x_spec``); it rides its seq axis unchanged: a
hop goes from (stage s, seq q) to (stage s + 1, seq q), and the stage may
run collectives over the seq axis itself (``attn_impl="ring_local"``).

Dropout: ``apply_fn(stage_params, h, seed)`` with ``seed`` from
``stage_seed(key, stage, microbatch)``, the rule ``models.long_context``'s
sequential twin uses too.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    ppermute_shift,
    psum,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import Mesh

STAGE_AXIS = "stage"

_MASK = (1 << 63) - 1


def stage_seed(key: int, stage: int, microbatch: int) -> int:
    """The seed of stage ``stage`` on microbatch ``microbatch`` from the
    base seed ``key``: the port's counterpart of the JAX package's
    ``fold_in(fold_in(key, stage), microbatch)``, which torch's generators
    cannot reproduce."""
    mixed = (key * 0x9E3779B97F4A7C15 + (stage + 1) * 0xBF58476D1CE4E5B9
             + (microbatch + 1) * 0x94D049BB133111EB)
    return mixed & _MASK


def pipeline_apply(stage_params: Any, x: torch.Tensor,
                   apply_fn: Callable[..., torch.Tensor], mesh: Mesh,
                   axis: str = STAGE_AXIS, n_micro: Optional[int] = None,
                   key: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` through the ``n_stages`` stages pipelined over ``axis``.

    ``stage_params`` is this rank's stage (a module, a tree of tensors:
    whatever ``apply_fn`` takes); ``apply_fn(stage_params, h) -> h`` keeps
    ``h``'s shape. ``x`` is (batch, ...), the same on every rank of the
    axis (only stage 0 reads it), split into ``n_micro`` microbatches
    (default ``n_stages``; the batch must divide). With ``key`` (an int)
    ``apply_fn`` is called as ``apply_fn(stage_params, h, seed)`` with
    ``seed = stage_seed(key, stage, microbatch)``. Returns the (batch, ...)
    outputs on every rank of the axis."""
    n_stages = mesh.shape[axis]
    n_micro = n_micro or n_stages
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")
    stage = mesh.axis_index(axis)
    last = n_stages - 1
    xs = x.chunk(n_micro)
    ticks = n_micro + n_stages - 1
    grad = torch.is_grad_enabled()
    recv = None
    outs = []
    h = xs[0] * 0
    for t in range(ticks):
        m = t - stage
        if 0 <= m < n_micro:
            h = xs[m] if stage == 0 else recv
            if stage == 0 and recv is not None:
                h = h + recv * 0
            h = (apply_fn(stage_params, h) if key is None else
                 apply_fn(stage_params, h, stage_seed(key, stage, m)))
            if stage == last:
                outs.append(h)
        elif recv is not None:
            h = recv * 0
        if t < ticks - 1:
            if grad and not h.requires_grad:
                # a hop's backward runs where its input needs a gradient:
                # on every rank, or a rank waits for a peer that skips it
                h = h.detach().requires_grad_()
            recv = ppermute_shift(h, axis, 1, mesh)
    # the last stage holds the outputs; the others hand zeros that hang
    # on their chain's last value
    y = torch.cat(outs) if stage == last else (h * 0).repeat(
        n_micro, *([1] * (h.dim() - 1)))
    return psum(y, axis, mesh)


def shard_stage_params(stacked_params: Any, mesh: Mesh,
                       axis: str = STAGE_AXIS) -> Any:
    """This rank's stage of stage-stacked params (a tensor, or a dict, list
    or tuple of them, each with a leading axis of the stage axis's size):
    the block of the stage axis the JAX package puts on this device."""
    i = mesh.axis_index(axis)
    n = mesh.shape[axis]

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cut(v) for v in t)
        if t.shape[0] != n:
            raise ValueError(f"a stacked leading axis of {t.shape[0]} on a "
                             f"{axis!r} axis of {n}")
        return t[i]

    return cut(stacked_params)
