"""Collectives over the axes of a mesh. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/collectives.py``.

Each collective takes a tensor or a tree of them (dict, list, tuple), an
axis name (or a tuple of them) and a ``Mesh`` (default: the active one,
``with mesh:``), and runs over this rank's process group along that axis.
``psum``, ``pmean``, ``all_gather`` and ``ppermute_shift`` are
differentiable, and their backward is the transpose JAX takes:

- ``psum``: ``psum`` of the cotangent (and ``pmean``: ``pmean``);
- ``all_gather`` (tiled along ``axis``): the sum of the cotangents over the
  group, sliced to this rank's block (a reduce-scatter of the sum, run as an
  all-reduce and a slice, which gloo has and NCCL too);
- ``ppermute_shift(+s)``: ``ppermute_shift(−s)``.

``pmean_grads`` averages gradients (not differentiable): one all-reduce per
dtype and device over a flat buffer. ``broadcast`` (not differentiable)
hands a dict of host arrays from one rank to a process group, shapes and
dtypes included: the port's own plumbing for ``serving.DynamicBatcher`` over
a planned ensemble, where one rank holds the request queue (the JAX
package's inputs are replicated inside one process).

Transport: an NCCL group takes CUDA tensors as they are, and a host tensor
goes through the current card. A gloo group takes host tensors, so a CUDA
tensor goes through pinned host memory here (copied to the host, reduced or
sent there, copied back); ``staged_bytes()`` counts the bytes those copies
move, both ways, and those of a host tensor through the card on NCCL.
Nothing else differs between the two backends. An axis of one rank with no
process group (a layout-only mesh) returns its input; a group of one runs
the collective.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    AxisNames,
    Mesh,
    resolve_mesh,
)

_STAGED = {"bytes": 0}


def staged_bytes() -> int:
    """Bytes copied between a CUDA device and host memory to run a
    collective (a CUDA tensor on a gloo group, a host tensor on an NCCL
    group) since the last ``reset_staged_bytes()``."""
    return _STAGED["bytes"]


def reset_staged_bytes() -> None:
    _STAGED["bytes"] = 0


def _flatten(tree) -> tuple:
    """(leaves, rebuild) of a tensor or a dict/list/tuple of tensors."""
    if torch.is_tensor(tree):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return ([tree[k] for k in keys],
                lambda leaves: dict(zip(keys, leaves)))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda leaves: kind(leaves)
    raise TypeError(f"expected a tensor or a dict/list/tuple of them, got "
                    f"{type(tree)}")


def _tree_map(fn: Callable, tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(t) for t in leaves])


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    _STAGED["bytes"] += host.numel() * host.element_size()
    return host


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    _STAGED["bytes"] += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


def _to_card(x: torch.Tensor) -> torch.Tensor:
    """A host tensor on the current card, for an NCCL group."""
    _STAGED["bytes"] += x.numel() * x.element_size()
    return x.to(torch.cuda.current_device())


def _from_card(card: torch.Tensor, device) -> torch.Tensor:
    _STAGED["bytes"] += card.numel() * card.element_size()
    return card.to(device)


def _transport(x: torch.Tensor, group,
               op: Callable[[torch.Tensor], Any]) -> torch.Tensor:
    """Run ``op`` in place on a contiguous copy of ``x`` that the group's
    backend takes, and return it on ``x``'s device."""
    if x.is_cuda and _on_host(group):
        host = _to_host(x)
        op(host)
        return _to_device(host, x.device)
    if not x.is_cuda and not _on_host(group):
        card = _to_card(x)
        op(card)
        return _from_card(card, x.device)
    y = x.contiguous().clone()
    op(y)
    return y


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _transport(x, group, lambda t: dist.all_reduce(t, group=group))


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    staged = x.is_cuda and _on_host(group)
    on_card = not x.is_cuda and not _on_host(group)
    src = (_to_host(x) if staged else _to_card(x) if on_card
           else x.contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = [_to_device(p, x.device) for p in parts]
    out = torch.cat(parts, axis)
    return _from_card(out, x.device) if on_card else out.to(x.device)


def _ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if shift % n == 0:
        return x.clone()
    i = ranks.index(dist.get_rank())
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]

    def exchange(t):
        recv = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        t.copy_(recv)

    return _transport(x, group, exchange)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis, ctx.size = group, axis, x.shape[axis]
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_process_group_ranks(ctx.group).index(dist.get_rank())
        summed = _all_reduce(g, ctx.group)
        return summed.narrow(ctx.axis, i * ctx.size, ctx.size), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


def psum(x: Any, axis_name: AxisNames = DATA_AXIS,
         mesh: Optional[Mesh] = None):
    """Sum over the ranks of ``axis_name``; every rank gets the sum."""
    group = resolve_mesh(mesh).group(axis_name)
    if group is None:
        return x
    return _tree_map(lambda t: _PSum.apply(t, group), x)


def pmean(x: Any, axis_name: AxisNames = DATA_AXIS,
          mesh: Optional[Mesh] = None):
    n = resolve_mesh(mesh).axis_size(axis_name)
    return _tree_map(lambda t: t / n, psum(x, axis_name, mesh))


def all_gather(x: Any, axis_name: AxisNames = DATA_AXIS, axis: int = 0,
               mesh: Optional[Mesh] = None):
    """The ranks' tensors concatenated along ``axis`` in rank order along
    the mesh axis (JAX's ``all_gather(..., tiled=True)``)."""
    group = resolve_mesh(mesh).group(axis_name)
    if group is None:
        return x
    return _tree_map(lambda t: _AllGather.apply(t, group, axis), x)


def ppermute_shift(x: Any, axis_name: str, shift: int = 1,
                   mesh: Optional[Mesh] = None):
    """Ring shift along a mesh axis: the value of index i moves to index
    (i + shift) mod n. The leaves of a tree of one dtype and device go as
    one message."""
    group = resolve_mesh(mesh).group(axis_name)
    if group is None:
        return x
    leaves, rebuild = _flatten(x)
    if len({(t.dtype, t.device) for t in leaves}) != 1:
        return rebuild([_PPermute.apply(t, group, shift) for t in leaves])
    flat = _PPermute.apply(torch.cat([t.reshape(-1) for t in leaves]),
                           group, shift)
    parts = flat.split([t.numel() for t in leaves])
    return rebuild([p.view(t.shape) for p, t in zip(parts, leaves)])


_STOP, _CALL = 0, 1
_KINDS = "biufc"            # numpy kinds a buffer carries bit for bit


def _bcast_host(buf: torch.Tensor, src: int, group, sender: bool
                ) -> torch.Tensor:
    """``buf`` (a host tensor) of rank ``src``, into ``buf`` on the
    others: as it is on gloo, through the current card on NCCL."""
    if not buf.numel():
        return buf
    if _on_host(group):
        dist.broadcast(buf, src, group=group)
        return buf
    card = (_to_card(buf) if sender else torch.empty(
        buf.shape, dtype=buf.dtype, device=torch.cuda.current_device()))
    dist.broadcast(card, src, group=group)
    if not sender:
        _STAGED["bytes"] += card.numel() * card.element_size()
        buf.copy_(card)
    return buf


@torch.no_grad()
def broadcast(arrays: Optional[Mapping[str, np.ndarray]], src: int = 0,
              group=None) -> Optional[Dict[str, np.ndarray]]:
    """Global rank ``src``'s ``arrays`` (a dict of numeric host arrays) on
    every rank of ``group`` (default: the world), which every rank calls;
    ``None`` is a stop, which every rank gets as None. The other ranks'
    argument is ignored. Every rank gets the arrays by sorted key,
    contiguous, with the sender's shapes and dtypes, bit for bit (``src``
    its own). Three messages: a fixed-size word (stop or call, and the
    header's length), the header (the sorted keys, each array's shape and
    dtype), then every array's bytes in one buffer. ``src`` checks the
    arrays before it sends anything: a dtype that is not a number raises
    there, and nothing goes out."""
    sender = dist.get_rank() == src
    word = torch.zeros(2, dtype=torch.int64)
    if sender and arrays is not None:
        arrays = {k: np.asarray(arrays[k], order="C")
                  for k in sorted(arrays)}
        bad = {k: str(a.dtype) for k, a in arrays.items()
               if a.dtype.kind not in _KINDS}
        if bad:
            raise TypeError(f"broadcast carries numeric arrays only, got "
                            f"{bad}")
        header = np.frombuffer(json.dumps(
            [[k, list(a.shape), a.dtype.str] for k, a in arrays.items()]
        ).encode(), np.uint8).copy()
        payload = np.concatenate(
            [a.reshape(-1).view(np.uint8) for a in arrays.values()]
            or [np.zeros(0, np.uint8)])
        word[:] = torch.tensor([_CALL, len(header)])
    _bcast_host(word, src, group, sender)
    if int(word[0]) == _STOP:
        return None
    if not sender:
        header = np.empty(int(word[1]), np.uint8)
    _bcast_host(torch.from_numpy(header), src, group, sender)
    if sender:
        _bcast_host(torch.from_numpy(payload), src, group, sender)
        return arrays
    meta = [(k, tuple(shape), np.dtype(dtype))
            for k, shape, dtype in json.loads(header.tobytes())]
    sizes = [int(np.prod(shape)) * dtype.itemsize for _, shape, dtype in meta]
    payload = np.empty(sum(sizes), np.uint8)
    _bcast_host(torch.from_numpy(payload), src, group, sender)
    out, at = {}, 0
    for (k, shape, dtype), n in zip(meta, sizes):
        out[k] = payload[at:at + n].view(dtype).reshape(shape).copy()
        at += n
    return out


@torch.no_grad()
def pmean_grads(grads: Any, axis_name: AxisNames = DATA_AXIS,
                mesh: Optional[Mesh] = None):
    """The mean of each gradient over the ranks of ``axis_name`` (the
    data-parallel all-reduce), one all-reduce per dtype and device."""
    mesh = resolve_mesh(mesh)
    group = mesh.group(axis_name)
    if group is None:
        return grads
    n = mesh.axis_size(axis_name)
    leaves, rebuild = _flatten(grads)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    buckets = {}
    for i, t in enumerate(leaves):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = _all_reduce(torch.cat([leaves[i].reshape(-1) for i in idx]),
                           group).div_(n)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return rebuild(out)


@torch.no_grad()
def reduce_grads_(grads: Dict[str, torch.Tensor],
                  sharded: Dict[str, Tuple[str, ...]], mesh: Mesh) -> None:
    """Each gradient, in place, summed over the mesh axes its parameter is
    replicated on and divided by the mesh's size: with every rank's loss
    the one global loss, each rank's backward gives the gradient of the
    ranks' summed losses in its own copy of a parameter (the collectives'
    transposes carry the rest), so this is the gradient of the global loss
    in the parameter's shard, as GSPMD computes it. ``sharded`` gives each
    parameter's sharded axes (absent: replicated on every axis). A
    parameter replicated everywhere gets ``pmean_grads`` over all axes."""
    n = mesh.axis_size(mesh.axis_names)
    groups: Dict[Tuple[str, ...], List[str]] = {}
    for name in grads:
        own = set(sharded.get(name, ()))
        rest = tuple(a for a in mesh.axis_names if a not in own)
        groups.setdefault(rest, []).append(name)
    for rest, names in groups.items():
        gs = [grads[k] for k in names]
        if not rest:
            torch._foreach_div_(gs, n)
            continue
        mean = pmean_grads(gs, rest, mesh)
        if len(rest) < len(mesh.axis_names):
            # pmean_grads divided by the replicated axes' size only
            torch._foreach_mul_(mean, mesh.axis_size(rest) / n)
        torch._foreach_copy_(gs, mean)


@torch.no_grad()
def global_norm(grads: Dict[str, torch.Tensor],
                sharded: Dict[str, Tuple[str, ...]],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """‖g‖ of the whole gradient: a sharded parameter's squared norm summed
    over the axes it is sharded on, a replicated one counted once. Every
    rank gets the same value."""
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for name, g in grads.items():
        groups.setdefault(tuple(sharded.get(name, ())), []).append(g)
    if set(groups) == {()}:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(groups[()])))
    total = 0.0
    for axes, gs in sorted(groups.items()):
        sq = torch.stack(torch._foreach_norm(gs)).square().sum()
        total = total + (psum(sq, axes, mesh) if axes else sq)
    return total.sqrt()
