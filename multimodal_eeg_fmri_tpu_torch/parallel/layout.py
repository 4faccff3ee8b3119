"""Parameter layouts over a mesh: the machinery under ``parallel/tensor.py``,
``parallel/fsdp.py`` and ``parallel/expert.py``.

The JAX package writes a layout as ``PartitionSpec``s on its flax params and
lets GSPMD derive the program. The port is SPMD: each rank holds its shard
of a sharded parameter as the parameter itself (same name, the local
shape), and the layers compute with it.

- A spec is a tuple with one entry a dimension of the port's tensor, a mesh
  axis name or None; ``()`` is replicated. Specs are computed in the flax
  layout, where the JAX package computes them (``flax_layout``: each port
  parameter's flax shape, leaf name and the dimension each flax dimension
  lands on), and carried over, so that they are the JAX package's.
- ``apply_layout`` cuts each parameter to this rank's block. Axes in
  ``gather_axes`` (FSDP's ``data``) are gathered back before each use: a
  forward pre-hook on the module that reads the parameter swaps the
  all-gathered tensor in (differentiable: its transpose sums the
  cotangents over the axis and keeps this rank's block, a reduce-scatter)
  and the forward hook swaps the shard back. Other axes (tensor
  parallelism's ``model``, expert parallelism's ``expert``) stay local: the
  layers compute on the shard and reduce where the contraction crosses it.
- ``param_axes(model)``: the mesh axes each parameter is sharded over (its
  spec's, and a pipeline stage's block over the stage axis); the train step
  reduces each gradient over the mesh's other axes
  (``collectives.reduce_grads``).
- ``full_tree`` / ``local_tree``: a tree of tensors by parameter name
  (params, AdamW moments, EMA) between the local shards and the gathered
  full tensors that checkpoints keep. ``full_tree`` is collective.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.parallel.mesh import Mesh, Spec


class FlaxLeaf:
    """A port parameter seen in the flax layout: ``shape`` the flax leaf's,
    ``path`` its flax path (module names, then the leaf name), ``dims`` the
    port dimension each flax dimension lands on. Flax dimensions that land
    on one port dimension merge into it in their flax order (the heads
    before the head dimension), so a block of the port dimension is a block
    of a flax dimension only where those merged before it have size 1."""

    def __init__(self, path, shape, dims):
        self.path = tuple(path)
        self.shape = tuple(int(s) for s in shape)
        self.dims = tuple(dims)
        # flax dimensions in the order the port's tensor holds them
        self._perm = sorted(range(len(self.dims)), key=self.dims.__getitem__)
        self._inner = tuple(any(self.dims[j] == d and self.shape[j] != 1
                                for j in range(i))
                            for i, d in enumerate(self.dims))

    def port_array(self, value) -> np.ndarray:
        """A flax leaf's value in the port tensor's layout."""
        value = np.asarray(value)
        if value.shape != self.shape:
            raise ValueError(f"{'/'.join(self.path)}: flax shape "
                             f"{value.shape}, expected {self.shape}")
        shape = [1] * (max(self.dims, default=-1) + 1)
        for size, d in zip(self.shape, self.dims):
            shape[d] *= size
        return value.transpose(self._perm).reshape(shape)

    def flax_array(self, value) -> np.ndarray:
        """A port tensor's value (a numpy array) in the flax layout; the
        inverse of ``port_array``."""
        return np.asarray(value).reshape(
            [self.shape[i] for i in self._perm]).transpose(
                np.argsort(self._perm))

    def to_port(self, spec: Spec, ndim: int) -> Spec:
        """A flax-layout spec as the port tensor's spec."""
        if not any(a is not None for a in spec):
            return ()
        out = [None] * ndim
        for i, a in enumerate(spec):
            if a is None:
                continue
            if self._inner[i]:
                raise ValueError(
                    f"{'/'.join(self.path)}: a layout on flax dimension {i} "
                    "is not a block of the port's merged dimension")
            if out[self.dims[i]] is not None:
                raise ValueError(f"{'/'.join(self.path)}: two axes on one "
                                 "port dimension")
            out[self.dims[i]] = a
        return tuple(out)

    def to_flax(self, spec: Spec) -> Spec:
        """The port tensor's spec in the flax layout (the inverse of
        ``to_port``: an axis on a merged port dimension is on its first
        flax dimension)."""
        if not spec_axes(spec):
            return ()
        out = [None] * len(self.shape)
        for d, a in enumerate(spec):
            if a is not None:
                out[self.dims.index(d)] = a
        return tuple(out)


def port_specs(model: nn.Module, flax_spec) -> Dict[str, Spec]:
    """``flax_spec(leaf) -> spec in the flax layout`` for every parameter
    of ``model``, carried over to the port's layout."""
    return {name: leaf.to_port(flax_spec(name, leaf),
                               model.get_parameter(name).dim())
            for name, leaf in flax_layout(model).items()}


def flax_layout(model: nn.Module) -> Dict[str, FlaxLeaf]:
    """Each parameter of ``model`` by name, seen in the flax layout of its
    JAX counterpart: Dense kernels (in, out) against the port's (out, in),
    the multi-head projections' DenseGeneral kernels (d, H, hd) and
    (H, hd, d) and q/k/v biases (H, hd), Conv kernels (K, Cin, Cout)
    against (Cout, Cin, K), norms' ``scale``; everything else as it is. A
    laid-out parameter is seen at its full shape. The one map between the
    two layouts: ``convert`` moves weights with it, the sharding modules
    carry specs with it."""
    from multimodal_eeg_fmri_tpu_torch.models.layers import (
        MultiHeadAttention,
    )

    specs = getattr(model, "param_specs", None) or {}
    out = {}
    for mname, module in model.named_modules():
        prefix = mname.split(".") if mname else []
        parent_name, _, attr = mname.rpartition(".")
        parent = model.get_submodule(parent_name) if mname else None
        heads = (parent.num_heads if isinstance(parent, MultiHeadAttention)
                 else None)
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            shape = _full_shape(p.shape, specs.get(name, ()), model.mesh
                                ) if name in specs else tuple(p.shape)
            if isinstance(module, nn.Linear) and leaf == "weight":
                o, i = shape
                if heads is not None and attr != "out_proj":
                    fl = FlaxLeaf(prefix + ["kernel"], (i, heads, o // heads),
                                  (1, 0, 0))
                elif heads is not None:
                    fl = FlaxLeaf(prefix + ["kernel"], (heads, i // heads, o),
                                  (1, 1, 0))
                else:
                    fl = FlaxLeaf(prefix + ["kernel"], (i, o), (1, 0))
            elif isinstance(module, nn.Linear) and leaf == "bias":
                (o,) = shape
                if heads is not None and attr != "out_proj":
                    fl = FlaxLeaf(prefix + ["bias"], (heads, o // heads),
                                  (0, 0))
                else:
                    fl = FlaxLeaf(prefix + ["bias"], (o,), (0,))
            elif isinstance(module, nn.Conv1d) and leaf == "weight":
                fl = FlaxLeaf(prefix + ["kernel"], shape[::-1], (2, 1, 0))
            elif (isinstance(module, (nn.LayerNorm, nn.BatchNorm1d))
                  and leaf == "weight"):
                fl = FlaxLeaf(prefix + ["scale"], shape, (0,))
            else:
                fl = FlaxLeaf(prefix + [leaf], shape, range(p.dim()))
            out[name] = fl
    return out


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for a in spec if a is not None)


def _block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    for dim, a in enumerate(spec):
        if a is None:
            continue
        n, i = mesh.shape[a], mesh.axis_index(a)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide the {a!r} axis ({n})")
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t


def _full_shape(local: torch.Size, spec: Spec, mesh: Mesh) -> tuple:
    shape = list(local)
    for dim, a in enumerate(spec):
        if a is not None:
            shape[dim] *= mesh.shape[a]
    return tuple(shape)


def _gather(t: torch.Tensor, dims: Iterable[Tuple[int, str]], mesh: Mesh):
    from multimodal_eeg_fmri_tpu_torch.parallel.collectives import all_gather

    for dim, a in dims:
        t = all_gather(t, a, axis=dim, mesh=mesh)
    return t


class _GatherHooks:
    """The FSDP gathers of one module's forward: before it, each listed
    parameter (of the module or of a child whose parameters it reads) is
    swapped for its all-gather; after it, the shard goes back."""

    def __init__(self, holder: nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.items = []            # (owner, leaf, [(dim, axis)])
        self.saved = []
        holder.register_forward_pre_hook(self.pre)
        holder.register_forward_hook(self.post, always_call=True)

    def pre(self, module, args):
        self.saved.append([(o, leaf, o._parameters[leaf])
                           for o, leaf, _ in self.items])
        for owner, leaf, dims in self.items:
            owner._parameters[leaf] = _gather(owner._parameters[leaf], dims,
                                              self.mesh)

    def post(self, module, args, output):
        for owner, leaf, t in self.saved.pop():
            owner._parameters[leaf] = t


def _holder(model: nn.Module, module_name: str) -> nn.Module:
    """The module whose forward reads the parameters of ``module_name``:
    itself, or its parent where the parent reads them directly (it lists
    the child in ``_reads_child_params``, as ``MoEFFN`` its router)."""
    parent_name, _, attr = module_name.rpartition(".")
    parent = model.get_submodule(parent_name) if module_name else None
    if parent is not None and attr in getattr(parent, "_reads_child_params",
                                              ()):
        return parent
    return model.get_submodule(module_name)


def apply_layout(model: nn.Module, mesh: Mesh, specs: Dict[str, Spec],
                 gather_axes: Tuple[str, ...] = ()) -> nn.Module:
    """Cut each parameter with a non-empty spec to this rank's block, in
    place (a parameter already laid out is left as it is), and gather the
    ``gather_axes`` back around each use. Records the specs in
    ``model.param_specs`` and the mesh in ``model.mesh``; returns
    ``model``."""
    own = getattr(model, "mesh", None)
    if own is not None and own is not mesh:
        raise ValueError("the layout's mesh is not the model's mesh")
    done = getattr(model, "param_specs", None)
    if done is None:
        done = {}
        model.param_specs = done
    model.mesh = mesh
    hooks = getattr(model, "_gather_hooks", None)
    if hooks is None:
        hooks = {}
        model._gather_hooks = hooks
    for name, spec in specs.items():
        if not spec_axes(spec):
            continue
        if name in done:
            if done[name] != spec:
                raise ValueError(f"{name} is laid out as {done[name]}, not "
                                 f"{spec}")
            continue
        mname, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mname)
        p = owner._parameters[leaf]
        with torch.no_grad():
            shard = _block(p.detach(), spec, mesh).clone()
        owner._parameters[leaf] = nn.Parameter(shard,
                                               requires_grad=p.requires_grad)
        done[name] = tuple(spec)
        dims = [(d, a) for d, a in enumerate(spec) if a in gather_axes]
        if dims:
            holder = _holder(model, mname)
            if id(holder) not in hooks:
                hooks[id(holder)] = _GatherHooks(holder, mesh)
            hooks[id(holder)].items.append((owner, leaf, dims))
    return model


def param_axes(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The mesh axes each parameter of ``model`` is sharded over (absent:
    replicated on every axis of ``model.mesh``)."""
    out = {n: spec_axes(s) for n, s in
           (getattr(model, "param_specs", None) or {}).items()}
    for n, axes in (getattr(model, "stage_param_axes", None) or {}).items():
        out[n] = tuple(dict.fromkeys(out.get(n, ()) + tuple(axes)))
    return {n: a for n, a in out.items() if a}


@torch.no_grad()
def full_tree(model: nn.Module, tree: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """``tree`` (tensors by parameter or state-dict name, local shards) with
    every sharded entry all-gathered to its full tensor; collective over the
    model's mesh, so every rank calls it."""
    own = getattr(model, "_full_tree", None)
    if own is not None:
        return own(tree)
    specs = getattr(model, "param_specs", None) or {}
    out = dict(tree)
    for name in sorted(tree):
        spec = specs.get(name, ())
        if spec_axes(spec):
            out[name] = _gather(tree[name],
                                [(d, a) for d, a in enumerate(spec) if a],
                                model.mesh)
    return out


def local_tree(model: nn.Module, tree: Optional[Dict[str, torch.Tensor]]
               ) -> Optional[Dict[str, torch.Tensor]]:
    """``tree`` with every full tensor of a sharded parameter cut to this
    rank's block (local entries are kept): the layout re-applied to a
    restored carry's params, AdamW moments, best params and EMA."""
    if tree is None:
        return None
    own = getattr(model, "_local_tree", None)
    if own is not None:
        return own(tree)
    specs = getattr(model, "param_specs", None) or {}
    local = dict(model.named_parameters())
    out = dict(tree)
    for name, spec in specs.items():
        if name not in tree or not spec_axes(spec):
            continue
        t = tree[name]
        if tuple(t.shape) == _full_shape(local[name].shape, spec, model.mesh):
            out[name] = _block(t, spec, model.mesh).clone()
    return out

