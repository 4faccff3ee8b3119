"""Device mesh over ``torch.distributed`` ranks, and the sharding helpers.
Counterpart of ``multimodal_eeg_fmri_tpu/parallel/mesh.py``.

A ``Mesh`` lays the ranks of the default process group out on named axes
(an integer array of global ranks, one rank a device), and owns one process
group per line of ranks along every set of its axes: ``group(axes)`` is
this rank's. The port is SPMD: every rank runs the same program on its own
shard, and the collectives (``parallel/collectives.py``) name an axis where
the JAX package's ``shard_map`` bodies name a mesh axis. Built in a process
with no process group, a mesh is a layout only: axes of size 1 need no
group, and a collective over a larger axis raises.

``with mesh:`` makes a mesh the active one, for code that names an axis
without holding a mesh (``attn_impl="ring_local"``, as the JAX package's
body inside ``shard_map`` names the bound axis). A mesh is shared, not
copied, by ``copy.deepcopy`` of the module that holds it.

The sharding helpers: where the JAX package builds a ``NamedSharding``,
``replicated``, ``batch_sharding``, ``ensemble_sharding`` and
``ensemble_batch_sharding`` return its ``PartitionSpec`` as the port's spec
(``parallel/layout.py``: a tuple of axis names or None, ``()``
replicated); where it ``device_put``s host arrays with one, ``shard_batch``
and ``shard_ensemble_tree`` return this rank's block of them
(``parallel/input.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

ENSEMBLE_AXIS = "ensemble"
DATA_AXIS = "data"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)
# (mesh, axis) of the batch rows inside ``batch_sharded``
_BATCH: contextvars.ContextVar = contextvars.ContextVar("batch_axis",
                                                        default=None)

AxisNames = Union[str, Sequence[str]]


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks on named axes: ``ranks`` is an array of the global ranks
    0..n-1, one array axis per name. ``shape`` maps each name to its size,
    ``coords`` this rank's index along it. ``rank`` defaults to the process
    group's own (0 without one); a mesh built for another rank than this
    process's is a layout only."""

    def __init__(self, ranks, axis_names: Sequence[str],
                 rank: Optional[int] = None):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names) or len(set(axis_names)) != ranks.ndim:
            raise ValueError(f"{ranks.ndim}-D ranks need as many distinct "
                             f"axis names, got {axis_names}")
        if sorted(ranks.ravel().tolist()) != list(range(ranks.size)):
            raise ValueError(f"the mesh must hold the ranks 0..{ranks.size - 1}"
                             f" once each, got {ranks.ravel().tolist()}")
        live = dist.is_available() and dist.is_initialized()
        me, size = world()
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.rank = me if rank is None else int(rank)
        at = np.argwhere(ranks == self.rank)
        if not len(at):
            raise ValueError(f"rank {self.rank} is not in the mesh")
        self.coords = dict(zip(axis_names, (int(c) for c in at[0])))
        self._groups = {}
        self._tokens = []
        if live and rank in (None, me):
            if size != ranks.size:
                raise ValueError(f"a mesh of {ranks.size} ranks in a world "
                                 f"of {size}")
            # every rank creates every group, in one order: new_group is
            # collective over the default group. A proper subset of the
            # axes gets a group per line; all of them are the world.
            for n in range(1, len(axis_names)):
                for subset in itertools.combinations(range(len(axis_names)),
                                                     n):
                    lines = np.moveaxis(ranks, subset, range(-n, 0))
                    lines = lines.reshape(-1, int(np.prod(
                        [ranks.shape[i] for i in subset])))
                    key = tuple(axis_names[i] for i in subset)
                    for line in lines:
                        g = dist.new_group(line.tolist())
                        if self.rank in line:
                            self._groups[key] = g
            self._groups[axis_names] = dist.group.WORLD

    def _axes(self, axis_name: AxisNames) -> Tuple[str, ...]:
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"no mesh axis {unknown} in {self.axis_names}")
        return axes

    def axis_size(self, axis_name: AxisNames) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis_name)]))

    def axis_index(self, axis_name: str) -> int:
        return self.coords[self._axes(axis_name)[0]]

    def group(self, axis_name: AxisNames):
        """The process group of this rank's line along ``axis_name`` (one
        axis or any set of them: over all of them, the world); None on a
        layout-only mesh, where the axes must hold one rank."""
        axes = self._axes(axis_name)
        if not self._groups:
            if self.axis_size(axes) == 1:
                return None
            raise RuntimeError(
                f"mesh axis {axes} holds {self.axis_size(axes)} ranks but "
                "the mesh has no process groups (initialize_distributed "
                "before building it)")
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    def __enter__(self) -> "Mesh":
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())

    def __deepcopy__(self, memo) -> "Mesh":
        return self

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords})")


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _ACTIVE.get()


def resolve_mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or enter one with `with mesh:`")
    return mesh


@contextlib.contextmanager
def batch_sharded(mesh: Optional[Mesh], axis: Optional[str]):
    """Inside the block the batch rows are sharded over ``axis`` of
    ``mesh`` (a no-op for None): training-mode BatchNorm takes its
    statistics over the whole batch and Mixture-of-Experts layers route the
    whole batch's tokens, as the JAX package computes them on a batch
    sharded over ``data``. ``train.fit`` enters it around its forwards."""
    if mesh is None or axis is None:
        yield
        return
    token = _BATCH.set((mesh, axis))
    try:
        yield
    finally:
        _BATCH.reset(token)


def current_batch_axis() -> Optional[Tuple[Mesh, str]]:
    """(mesh, axis) of the innermost ``batch_sharded``, or None."""
    return _BATCH.get()


def batch_axis_of(mesh: Optional[Mesh], seq_axis: Optional[str] = None
                  ) -> Optional[str]:
    """The axis a model's batch rows shard over: the mesh's ``data`` axis,
    unless that axis carries the sequence."""
    if mesh is None or DATA_AXIS not in mesh.shape or seq_axis == DATA_AXIS:
        return None
    return DATA_AXIS


@dataclass(frozen=True)
class MeshPlan:
    """A mesh plus the framework's canonical axis names."""

    mesh: Mesh
    ensemble_axis: str = ENSEMBLE_AXIS
    data_axis: str = DATA_AXIS

    @property
    def n_ensemble(self) -> int:
        return self.mesh.shape[self.ensemble_axis]

    @property
    def n_data(self) -> int:
        return self.mesh.shape[self.data_axis]

    @property
    def n_devices(self) -> int:
        return self.n_ensemble * self.n_data


def mesh_sizes(n: int, ensemble: int = 0, data: int = 0) -> Tuple[int, int]:
    """(ensemble, data) for ``n`` ranks; 0 infers a size: by default every
    rank goes to the ensemble axis."""
    if ensemble <= 0 and data <= 0:
        ensemble, data = n, 1
    elif ensemble <= 0:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        ensemble = n // data
    elif data <= 0:
        if n % ensemble:
            raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
        data = n // ensemble
    if ensemble * data != n:
        raise ValueError(f"mesh {ensemble}x{data} != {n} devices")
    return ensemble, data


def build_mesh(ensemble: int = 0, data: int = 0,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> MeshPlan:
    """A 2D (ensemble, data) mesh over the world's ranks in order
    (``world_size`` defaults to the process group's)."""
    n = world()[1] if world_size is None else world_size
    ensemble, data = mesh_sizes(n, ensemble, data)
    return MeshPlan(Mesh(np.arange(n).reshape(ensemble, data),
                         (ENSEMBLE_AXIS, DATA_AXIS), rank=rank))


# a layout: one mesh axis name (or None) per dimension; () is replicated
Spec = Tuple[Optional[str], ...]


def replicated(plan: MeshPlan) -> Spec:
    return ()


def batch_sharding(plan: MeshPlan, ndim: int = 1) -> Spec:
    """The leading (batch) dim over the data axis."""
    return (DATA_AXIS, *([None] * (ndim - 1)))


def ensemble_sharding(plan: MeshPlan, ndim: int = 1) -> Spec:
    """The leading (fold/trial/member) dim over the ensemble axis."""
    return (ENSEMBLE_AXIS, *([None] * (ndim - 1)))


def ensemble_batch_sharding(plan: MeshPlan, ndim: int = 2) -> Spec:
    """Dim 0 over ensemble and dim 1 over data: the layout of fold-stacked
    batches ``(n_folds, batch, ...)``."""
    return (ENSEMBLE_AXIS, DATA_AXIS, *([None] * (ndim - 2)))


def shard_batch(plan: MeshPlan, tree: Any) -> Any:
    """This rank's block of a tree of host arrays under ``batch_sharding``:
    its rows of the leading axis."""
    from multimodal_eeg_fmri_tpu_torch.parallel.input import global_batch_tree

    return global_batch_tree(plan, tree)


def shard_ensemble_tree(plan: MeshPlan, tree: Any) -> Any:
    """This rank's block of a tree whose leaves have a leading ensemble
    axis (fold-stacked params, say) under ``ensemble_sharding``."""
    from multimodal_eeg_fmri_tpu_torch.parallel.input import (
        global_ensemble_tree,
    )

    return global_ensemble_tree(plan, tree)


def ensemble_vmap(fn, plan: MeshPlan, in_axes=0):
    """Fold-parallel execution, SPMD: ``torch.func.vmap(fn)`` of each
    rank's block of the fold axis, the blocks gathered over the ensemble
    axis. Counterpart of the JAX package's ``vmap(fn)`` inside a
    ``shard_map`` over the ensemble axis.

    Every argument whose ``in_axes`` entry is not None carries a leading
    fold axis divisible by ``plan.n_ensemble``; each rank maps ``fn`` over
    its contiguous block (``shard_ensemble_tree``), with no collective
    inside, and every rank returns the whole fold axis of every result leaf
    (``parallel.input.gather_ensemble_tree``, one all-gather per dtype and
    device, no autograd through it). A fold's result does not depend on the
    rank that computes it: the result is the unsharded ``vmap(fn)``'s, the
    fold axis cut into blocks. The ``data`` axis is not mentioned: its
    ranks repeat their row's folds, as inputs replicate across it in the
    JAX package. Call it on every rank with the same arguments.

    ``in_axes`` follows ``jax.vmap``: an entry of None marks an argument
    SHARED across folds (every rank takes it whole), 0 one mapped over its
    leading fold axis; one entry stands for every argument."""
    import torch

    from multimodal_eeg_fmri_tpu_torch.parallel.input import (
        gather_ensemble_tree,
    )

    def call(*args):
        axes = (tuple(in_axes) if isinstance(in_axes, (tuple, list))
                else (in_axes,) * len(args))
        if len(axes) != len(args) or any(a not in (0, None) for a in axes):
            raise ValueError(f"in_axes must give 0 or None for each of the "
                             f"{len(args)} arguments, got {in_axes!r}")
        local = tuple(a if ax is None else shard_ensemble_tree(plan, a)
                      for a, ax in zip(args, axes))
        out = torch.func.vmap(fn, in_dims=axes)(*local)
        return gather_ensemble_tree(plan, out)

    return call
