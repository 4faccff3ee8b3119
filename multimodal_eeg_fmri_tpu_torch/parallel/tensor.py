"""Tensor (model) parallelism: Megatron-style parameter sharding on
``torch.distributed``. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/tensor.py``.

The split is the JAX package's: attention heads and the FFN's hidden width
shard over a ``model`` mesh axis, q/k/v and ``ffn1`` column-parallel,
``out_proj`` and ``ffn2`` row-parallel, everything else replicated, and a
parameter whose sharded dimension does not divide the axis stays
replicated. The rules (``_RULES``) are the JAX package's, on the flax
layout (``parallel.layout.flax_layout``), so ``tp_param_specs`` gives the
JAX package's specs carried over to the port's tensors.

Where GSPMD derives the program from the layout, the port's layers run it:
each rank holds its slice of the heads (``MultiHeadAttention`` takes its
head count from its projections, so K1-K3 see the local heads) and of the
FFN's width, and the row-parallel projections all-reduce their products
over ``model`` before adding their (replicated) bias: the two all-reduces a
block that GSPMD inserts. A batch shards over ``data``
(``train.fit`` takes each rank's rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
from torch import nn

from multimodal_eeg_fmri_tpu_torch.parallel.layout import (
    Spec,
    apply_layout,
    port_specs,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import Mesh, mesh_sizes, world

DATA_AXIS = "data"
MODEL_AXIS = "model"

# (module name, leaf name) → the flax-layout spec, as the JAX package's:
# q/k/v kernels (d_model, heads, head_dim) shard heads; out_proj's kernel
# (heads, head_dim, d_model) shards heads (row-parallel); ffn1's kernel
# (d_model, ff) shards ff (column); ffn2's (ff, d_model) row-parallel
_RULES = {
    ("q_proj", "kernel"): (None, MODEL_AXIS, None),
    ("k_proj", "kernel"): (None, MODEL_AXIS, None),
    ("v_proj", "kernel"): (None, MODEL_AXIS, None),
    ("q_proj", "bias"): (MODEL_AXIS, None),
    ("k_proj", "bias"): (MODEL_AXIS, None),
    ("v_proj", "bias"): (MODEL_AXIS, None),
    ("out_proj", "kernel"): (MODEL_AXIS, None, None),
    ("out_proj", "bias"): (),
    ("ffn1", "kernel"): (None, MODEL_AXIS),
    ("ffn1", "bias"): (MODEL_AXIS,),
    ("ffn2", "kernel"): (MODEL_AXIS, None),
    ("ffn2", "bias"): (),
}
# the row-parallel projections, which reduce their product over the axis
_ROW_PARALLEL = ("out_proj", "ffn2")


@dataclass(frozen=True)
class TPPlan:
    """A (data, model) mesh for DP × TP training and serving."""

    mesh: Mesh

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.mesh.shape[MODEL_AXIS]


def build_tp_mesh(data: int = 0, model: int = 0,
                  world_size: Optional[int] = None,
                  rank: Optional[int] = None) -> TPPlan:
    """A 2D (data, model) mesh over the world's ranks in order. ``model=0``
    infers the rest; with both unset every rank goes to the model axis."""
    n = world()[1] if world_size is None else world_size
    if data <= 0 and model <= 0:
        data, model = 1, n
    model, data = mesh_sizes(n, model, data)
    return TPPlan(Mesh(np.arange(n).reshape(data, model),
                       (DATA_AXIS, MODEL_AXIS), rank=rank))


def tp_spec(path: tuple, shape: tuple) -> Spec:
    """The flax-layout spec of one parameter by (module, leaf) name;
    replicated where no rule matches."""
    if len(path) >= 2:
        spec = _RULES.get((path[-2], path[-1]))
        if spec is not None and len(shape) == len(spec):
            return spec
    return ()


def _divisible(shape: tuple, spec: Spec, n: int, axis: str) -> bool:
    return all(d % n == 0 for d, a in zip(shape, spec) if a == axis)


def tp_param_specs(model: nn.Module, n_model: int) -> Dict[str, Spec]:
    """Each parameter's spec by name, in the port's layout. A parameter
    whose head or FFN dimension does not divide the model axis stays
    replicated (correct, just not sharded)."""
    def spec(name, leaf):
        s = tp_spec(leaf.path, leaf.shape)
        return s if _divisible(leaf.shape, s, n_model, MODEL_AXIS) else ()

    return port_specs(model, spec)


def _mark_row_parallel(model: nn.Module, mesh: Mesh, axis: str) -> None:
    """The row-parallel projections whose weight is sharded reduce over the
    axis before their bias; the attention modules whose heads are sharded
    average their probabilities over every head."""
    from multimodal_eeg_fmri_tpu_torch.models.layers import (
        Dense,
        MultiHeadAttention,
    )

    specs = model.param_specs
    for name, module in model.named_modules():
        attr = name.rpartition(".")[2]
        if (attr in _ROW_PARALLEL and isinstance(module, Dense)
                and axis in specs.get(f"{name}.weight", ())):
            module.reduce_axis = (mesh, axis)
        if (isinstance(module, MultiHeadAttention)
                and axis in specs.get(f"{name}.q_proj.weight", ())):
            module.head_reduce = (mesh, axis)


def shard_params_tp(model: nn.Module, plan) -> nn.Module:
    """Lay ``model`` out for tensor parallelism over ``plan``'s (a
    ``TPPlan`` or a ``Mesh`` with a ``model`` axis) mesh, in place: each
    rank keeps its slice of the sharded parameters. Returns ``model``."""
    mesh = plan.mesh if isinstance(plan, TPPlan) else plan
    apply_layout(model, mesh, tp_param_specs(model, mesh.shape[MODEL_AXIS]))
    _mark_row_parallel(model, mesh, MODEL_AXIS)
    return model


def tp_param_constraint(plan):
    """The ``make_fit_fn(param_sharding=...)`` hook: ``model → model``,
    laying the model out for tensor parallelism before its optimizer is
    built (idempotent)."""
    return lambda model: shard_params_tp(model, plan)
