"""Expert parallelism: the Mixture-of-Experts weights over a mesh axis on
``torch.distributed``. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/expert.py``.

The stacked expert parameters ``w1`` (E, d, ff), ``b1`` (E, ff), ``w2``
(E, ff, d) and ``b2`` (E, d) of ``ops.moe.MoEFFN`` shard on their leading
expert dimension (the JAX package's rules); the router stays replicated,
since every token scores every expert. A layer whose E does not divide the
axis stays replicated (and warns once). At run time each rank holds E/n
experts and the tokens of its rows, routes them over the whole batch (the
capacity and the queue positions are the global batch's) and applies its
own experts; the outputs are summed over the expert axis
(``ops.moe.MoEFFN``).
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
EXPERT_AXIS = "expert"

# (module name, leaf name) → the flax-layout spec; keys on MoEFFN's names
_RULES = {
    ("moe", "w1"): (EXPERT_AXIS, None, None),
    ("moe", "b1"): (EXPERT_AXIS, None),
    ("moe", "w2"): (EXPERT_AXIS, None, None),
    ("moe", "b2"): (EXPERT_AXIS, None),
}


@dataclass(frozen=True)
class EPPlan:
    """A (data, expert) mesh for DP × EP training and serving."""

    mesh: Mesh

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_expert(self) -> int:
        return self.mesh.shape[EXPERT_AXIS]


def build_ep_mesh(data: int = 0, expert: int = 0,
                  world_size: Optional[int] = None,
                  rank: Optional[int] = None) -> EPPlan:
    """A 2D (data, expert) mesh over the world's ranks in order.
    ``expert=0`` infers the rest; with both unset every rank goes to the
    expert axis."""
    n = world()[1] if world_size is None else world_size
    if data <= 0 and expert <= 0:
        data, expert = 1, n
    expert, data = mesh_sizes(n, expert, data)
    return EPPlan(Mesh(np.arange(n).reshape(data, expert),
                       (DATA_AXIS, EXPERT_AXIS), rank=rank))


def ep_spec(path: tuple, shape: tuple) -> Spec:
    """The flax-layout spec of one parameter by (module, leaf) name;
    replicated where no rule matches."""
    if len(path) >= 2:
        spec = _RULES.get((path[-2], path[-1]))
        if spec is not None and len(shape) == len(spec):
            return spec
    return ()


def ep_param_specs(model: nn.Module, n_expert: int) -> Dict[str, Spec]:
    """Each parameter's spec by name, in the port's layout (the experts'
    rules applied where E divides the axis, everything else replicated)."""
    def spec(name, leaf):
        s = ep_spec(leaf.path, leaf.shape)
        return s if all(d % n_expert == 0 for d, a in zip(leaf.shape, s)
                        if a == EXPERT_AXIS) else ()

    return port_specs(model, spec)


def shard_params_ep(model: nn.Module, plan) -> nn.Module:
    """Lay ``model`` out for expert parallelism over ``plan``'s (an
    ``EPPlan`` or a ``Mesh`` with an ``expert`` axis) mesh, in place: each
    rank keeps its E/n experts. Every sharded ``MoEFFN`` must have been
    built with that mesh and ``expert_axis``. Returns ``model``."""
    from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN

    mesh = plan.mesh if isinstance(plan, EPPlan) else plan
    specs = ep_param_specs(model, mesh.shape[EXPERT_AXIS])
    for name, module in model.named_modules():
        if (isinstance(module, MoEFFN) and specs.get(f"{name}.w1")
                and (module.mesh is not mesh
                     or module.expert_axis != EXPERT_AXIS)):
            raise ValueError(f"{name}: build the MoE layers with mesh= and "
                             f"expert_axis={EXPERT_AXIS!r} to shard them")
    return apply_layout(model, mesh, specs)


def ep_param_constraint(plan):
    """The ``make_fit_fn(param_sharding=...)`` hook: ``model → model``,
    laying the experts out before the optimizer is built (idempotent)."""
    return lambda model: shard_params_ep(model, plan)
