"""Per-rank input feeding. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/input.py`` and of ``shard_sequence`` in
``multimodal_eeg_fmri_tpu/ops/ring_attention.py``.

The JAX package assembles a global array from each process's local rows;
the port is SPMD, so a global array is the set of its ranks' shards and
these functions go the other way: given the host arrays (numpy arrays or
tensors, a dict or a single array), each returns this rank's shard, the
block the JAX package's sharding puts on the device at this rank's place in
the mesh. Leaves keep their type and device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    Mesh,
    MeshPlan,
    world,
)

SEQ_AXIS = "data"  # the ring's default axis, as the JAX package's


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _block(x, axis: int, i: int, n: int, what: str):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{what}={size} not divisible by {n}")
    step = size // n
    index = [slice(None)] * x.ndim
    index[axis] = slice(i * step, (i + 1) * step)
    return x[tuple(index)]


def process_fold_range(n_folds: int, plan: Optional[MeshPlan] = None,
                       process_index: Optional[int] = None,
                       num_processes: Optional[int] = None
                       ) -> Tuple[int, int]:
    """[lo, hi) of the global fold axis that this process loads: each
    process owns a contiguous block of ``n_folds / num_processes`` folds
    (defaults: this rank and the world size)."""
    rank, size = world()
    if process_index is None:
        process_index = rank
    if num_processes is None:
        num_processes = size
    if plan is not None and plan.n_ensemble % num_processes:
        raise ValueError(
            f"ensemble axis ({plan.n_ensemble}) not divisible by process "
            f"count ({num_processes}) — use build_hybrid_mesh sizing")
    if n_folds % num_processes:
        raise ValueError(
            f"{n_folds} folds not divisible by {num_processes} processes; "
            "pad the fold list to the mesh's ensemble size first")
    per = n_folds // num_processes
    return process_index * per, (process_index + 1) * per


def global_ensemble_tree(plan: MeshPlan, tree: Any) -> Any:
    """This rank's block of the leading (fold, trial, member) axis, which
    shards over the ensemble axis."""
    i, n = plan.mesh.axis_index(plan.ensemble_axis), plan.n_ensemble
    return _map(lambda x: _block(x, 0, i, n, "folds"), tree)


@torch.no_grad()
def gather_ensemble_tree(plan: Optional[MeshPlan], tree: Any) -> Any:
    """Each leaf (a tensor or numpy array whose leading axis is this rank's
    block of the ensemble axis, as ``global_ensemble_tree`` cuts it)
    concatenated over the ranks of the ensemble axis, in their order: every
    rank gets the whole axis. Collective over the ensemble axis, one
    all-gather per dtype and device (leaves of one block size, the same
    tree on every rank); the identity without a plan. Numpy leaves come
    back as numpy, tensors on their device; None stays None."""
    from multimodal_eeg_fmri_tpu_torch.parallel.collectives import all_gather

    if plan is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    tensors = [torch.from_numpy(np.ascontiguousarray(x))
               if isinstance(x, np.ndarray) else x for x in leaves]
    buckets = {}
    for i, t in enumerate(tensors):
        if t is not None:
            buckets.setdefault((t.dtype, t.device), []).append(i)
    out = list(tensors)
    for idx in buckets.values():
        block = tensors[idx[0]].shape[0]
        flat = torch.cat([tensors[i].reshape(block, -1) for i in idx], 1)
        whole = all_gather(flat, plan.ensemble_axis, 0, plan.mesh)
        parts = whole.split([tensors[i][0].numel() for i in idx], 1)
        for i, part in zip(idx, parts):
            out[i] = part.reshape(-1, *tensors[i].shape[1:]).contiguous()
    out = [o.numpy() if isinstance(x, np.ndarray) else o
           for o, x in zip(out, leaves)]
    return pytree.tree_unflatten(out, spec)


def global_batch_tree(plan: MeshPlan, tree: Any) -> Any:
    """This rank's rows of the leading (batch) axis, which shards over the
    data axis (and is whole on every member of the ensemble axis)."""
    i, n = plan.mesh.axis_index(plan.data_axis), plan.n_data
    return _map(lambda x: _block(x, 0, i, n, "rows"), tree)


def shard_sequence(x: Any, mesh: Mesh, axis: str = SEQ_AXIS,
                   head_axis: Optional[str] = None) -> Any:
    """This rank's slice of the time axis of (B, T, C) leaves (axis 1) and
    of (B, H, T, D) leaves (axis 2, and with ``head_axis`` its slice of the
    heads too); leaves of fewer dims (labels, weights) are whole. Raises
    when T (or H) does not divide the axis size."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)

    def shard(v):
        if v.ndim < 3:
            return v
        t_axis = 1 if v.ndim == 3 else 2
        if v.shape[t_axis] % n:
            raise ValueError(f"T={v.shape[t_axis]} not divisible by ring "
                             f"size {n}")
        v = _block(v, t_axis, i, n, "T")
        if head_axis is not None and v.ndim == 4:
            v = _block(v, 1, mesh.axis_index(head_axis),
                       mesh.shape[head_axis], "H")
        return v

    return _map(shard, x)
