"""Fully-sharded data parallelism (FSDP / ZeRO-3) over the ``data`` axis on
``torch.distributed``. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/fsdp.py``.

Parameters, gradients and AdamW's state shard over the axis the batch
already shards over. The spec is the JAX package's shape logic, computed on
the flax layout: every float leaf of at least ``min_size`` elements shards
its largest dimension that ``n_shard`` divides, a ``base`` spec (tensor or
expert parallelism's) is extended on a free dimension and never
overwritten, and everything else stays replicated.

Runtime, as GSPMD derives it from that layout: each rank keeps its block of
a sharded parameter (so AdamW's moments come out at 1/n a rank); before a
module's forward its sharded parameters are all-gathered, and the gathered
copy is dropped after (``parallel.layout.apply_layout``); the gather's
transpose sums the cotangents over the axis and keeps this rank's block, a
reduce-scatter of the gradient. ``train.fit`` reduces each gradient over
the axes its parameter is replicated on only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.parallel.layout import (
    Spec,
    apply_layout,
    flax_layout,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import Mesh
from multimodal_eeg_fmri_tpu_torch.parallel.tensor import (
    MODEL_AXIS,
    _mark_row_parallel,
    tp_param_specs,
)

DATA_AXIS = "data"

# Leaves smaller than this many elements stay replicated: sharding a
# 75-element bias saves nothing and costs a gather. 2**11 (8 KiB of f32)
DEFAULT_MIN_SIZE = 2 ** 11


def fsdp_spec(shape: tuple, n_shard: int, *, axis: str = DATA_AXIS,
              base: Optional[Spec] = None,
              min_size: int = DEFAULT_MIN_SIZE) -> Spec:
    """The spec sharding ``shape``'s largest free dimension over ``axis``
    (the JAX package's rule, as a tuple). ``base`` is extended, never
    overwritten: only dimensions it leaves free are candidates. Returns
    ``base`` unchanged when the leaf is too small or no dimension divides
    ``n_shard``."""
    ndim = len(shape)
    entries = list(base) if base is not None else []
    entries += [None] * (ndim - len(entries))
    unchanged = (tuple(entries) if any(e is not None for e in entries)
                 else ())
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return unchanged
    cands = [d for d in range(ndim)
             if entries[d] is None and shape[d] % n_shard == 0]
    if not cands:
        return unchanged
    d = max(cands, key=lambda i: shape[i])
    entries[d] = axis
    return tuple(entries)


def fsdp_param_specs(model: nn.Module, n_shard: int, *,
                     axis: str = DATA_AXIS,
                     base: Optional[Dict[str, Spec]] = None,
                     min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Spec]:
    """Each parameter's spec by name, in the port's layout. ``base`` is an
    optional spec dict of the same model to extend: pass
    ``tp_param_specs(model, n_model)`` for the 2D FSDP×TP layout."""
    base = base or {}
    out = {}
    for name, leaf in flax_layout(model).items():
        p = model.get_parameter(name)
        b = leaf.to_flax(base.get(name, ()))
        if not torch.is_floating_point(p):
            out[name] = ()
            continue
        out[name] = leaf.to_port(
            fsdp_spec(leaf.shape, n_shard, axis=axis, base=b or None,
                      min_size=min_size), p.dim())
    return out


def shard_params_fsdp(model: nn.Module, mesh: Mesh, *, axis: str = DATA_AXIS,
                      base: Optional[Dict[str, Spec]] = None,
                      min_size: int = DEFAULT_MIN_SIZE) -> nn.Module:
    """Lay ``model`` out with the FSDP spec (extending ``base``) in place:
    each rank keeps its block of the sharded parameters and gathers
    ``axis`` around their use. Returns ``model``."""
    specs = fsdp_param_specs(model, mesh.shape[axis], axis=axis, base=base,
                             min_size=min_size)
    return apply_layout(model, mesh, specs, gather_axes=(axis,))


def fsdp_param_constraint(mesh: Mesh, *, axis: str = DATA_AXIS,
                          tp: bool = False,
                          min_size: int = DEFAULT_MIN_SIZE):
    """The ``make_fit_fn(param_sharding=...)`` hook: ``model → model``,
    laying the model out before its optimizer is built (idempotent).

    ``tp=True`` composes with tensor parallelism on a (data, model) mesh:
    attention and FFN parameters shard over both axes, the rest over
    ``data`` only. Other bases (expert parallelism's) go through
    ``shard_params_fsdp(model, mesh, base=...)``."""
    def constrain(model):
        base = tp_param_specs(model, mesh.shape[MODEL_AXIS]) if tp else None
        shard_params_fsdp(model, mesh, axis=axis, base=base,
                          min_size=min_size)
        if tp:
            _mark_row_parallel(model, mesh, MODEL_AXIS)
        return model

    return constrain
