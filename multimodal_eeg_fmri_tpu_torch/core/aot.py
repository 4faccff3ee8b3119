"""Ahead-of-time program bundles (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/core/aot.py``.

Where the JAX package serialises a lowered StableHLO program with
``jax.export``, the port serialises a ``torch.export`` program: the graph of
ATen and ``mmef`` operators that a function runs, specialised to the shapes
and dtypes of example arguments, weights NOT baked in (pass them as
arguments, through ``torch.func.functional_call``). A later process loads
it without the model's code and without tracing, and gets the same pytree
out. The flash attention operators stay operators in the graph: a loaded
program launches K1 in its forward and, since ``mmef::flash_fwd`` carries
its own gradient, K2 and K3 in its backward.

Use: ``export_jitted(fn, example_args, path)`` once, then ``fn =
load_bundle(path); fn(*args)`` in any process. ``bundle_or_jit`` keeps such
bundles in a directory keyed by the configuration and the arguments. A
bundle holds the graph, not the process's backend settings: a process that
loads it sets TF32 (``torch.backends.cudnn.allow_tf32``) and the
deterministic mode as the exporting one did to get the same numbers.

Custom pytree node types in the signature (``FitResult``, ``FitCarry``,
``ModelOutput``) need a serialised name, registered on BOTH sides;
``_register_tree_types`` walks a tree and registers every namedtuple and
dataclass it finds under its module and qualified name, and the port's
standard types are registered before every export and load. A bundle's
``.types.json`` manifest lists the names it needs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Callable, Sequence, Union

import torch
from torch import nn
from torch.utils import _pytree as pytree

_REGISTERED: set = set()


def _type_name(cls) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def _is_namedtuple(cls) -> bool:
    return (isinstance(cls, type) and issubclass(cls, tuple)
            and hasattr(cls, "_fields"))


def _register_one(cls) -> None:
    """Register ``cls`` (a namedtuple or dataclass) under its serialised
    name; anything else, and a type registered already, is left alone."""
    if cls in _REGISTERED:
        return
    if cls not in pytree.SUPPORTED_SERIALIZED_TYPES:
        name = _type_name(cls)
        if _is_namedtuple(cls):
            pytree._register_namedtuple(cls, serialized_type_name=name)
        elif dataclasses.is_dataclass(cls) and isinstance(cls, type):
            torch.export.register_dataclass(cls, serialized_type_name=name)
        else:
            return
    _REGISTERED.add(cls)


def _registered_names() -> set:
    return set(pytree.SERIALIZED_TYPE_TO_PYTHON_TYPE)


def _note(cls, names: set) -> None:
    if _is_namedtuple(cls) or (dataclasses.is_dataclass(cls)
                               and isinstance(cls, type)):
        _register_one(cls)
        names.add(_type_name(cls))


def _register_tree_types(tree: Any) -> set:
    """Register every namedtuple and dataclass node reachable in ``tree``;
    returns their serialised names (the bundle's manifest)."""
    names: set = set()

    def walk(x):
        if _is_namedtuple(type(x)):
            _note(type(x), names)
            for c in x:
                walk(c)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            _note(type(x), names)
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return names


def _spec_types(spec, names: set) -> set:
    """The serialised names of the custom nodes of a TreeSpec (a program's
    output structure), registered. A namedtuple node may carry the
    generic ``namedtuple`` as its type and its class as its context."""
    for cls in (spec.type, spec.context):
        if isinstance(cls, type):
            _note(cls, names)
    children = spec.children
    for child in children() if callable(children) else spec.children_specs:
        _spec_types(child, names)
    return names


def _register_fit_types() -> None:
    """The port's standard program node types, and the flash operators,
    registered eagerly so ``load_bundle`` works in a fresh process."""
    # registers mmef::flash_fwd and mmef::flash_bwd with their fakes,
    # vmap rules and gradient before a graph that holds them deserialises
    import multimodal_eeg_fmri_tpu_torch.ops.attention  # noqa: F401
    from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
    from multimodal_eeg_fmri_tpu_torch.train.fit import FitCarry, FitResult

    for cls in (FitResult, FitCarry, ModelOutput):
        _register_one(cls)


class _Program(nn.Module):
    """``fn`` as a module, the form ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


# the row counts a dynamic batch axis takes: a program traced on the card
# carries the guard rows ≤ 65,535 of its CUDA kernels' grids; a call outside
# the range gets a program specialised to its rows (``_dynamic``)
ROWS = (2, 65535)


def _dynamic(arg) -> bool:
    return ROWS[0] <= _batch_rows(arg) <= ROWS[1]


def _dynamic_shapes(example_args: tuple, batch_args: Sequence[int]):
    """``torch.export``'s dynamic shapes: the leading axis of every tensor
    of the arguments at ``batch_args``, one shared dim over ``ROWS``; None
    without."""
    if not batch_args:
        return None
    rows = torch.export.Dim("rows", min=ROWS[0], max=ROWS[1])
    return (tuple(
        pytree.tree_map(lambda x: {0: rows} if torch.is_tensor(x) else None,
                        a) if i in batch_args and _dynamic(a)
        else pytree.tree_map(lambda x: None, a)
        for i, a in enumerate(example_args)),)


def _batch_rows(arg) -> int:
    leaves = [x for x in pytree.tree_leaves(arg) if torch.is_tensor(x)]
    return leaves[0].shape[0] if leaves else 0


def export_jitted(fn: Callable, example_args: tuple,
                  path: Union[str, Path, None] = None,
                  batch_args: Sequence[int] = ()) -> bytes:
    """Serialise ``fn``, specialised to ``example_args``'s shapes and
    dtypes (their Python scalars as constants), to a self-contained bundle
    (a ``torch.export`` archive). ``batch_args`` lists the arguments whose
    tensors share a leading batch axis that the program takes at any length
    in ``ROWS`` (where the example's is in it). With ``path`` the bundle
    and its type manifest are written there (each by a rename, so a
    concurrent reader sees a whole file or none)."""
    _register_fit_types()
    example_args = tuple(example_args)
    names = _register_tree_types(example_args)
    ep = torch.export.export(_Program(fn), example_args,
                             dynamic_shapes=_dynamic_shapes(example_args,
                                                            batch_args),
                             strict=False)
    # outputs can carry further custom nodes (ModelOutput, FitResult)
    names |= _spec_types(ep.call_spec.out_spec, set())
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        # the type manifest first: a bundle on disk always has one
        _write(_types_sidecar(path), json.dumps(sorted(names)).encode())
        _write(Path(path), blob)
    return blob


def _write(path: Path, data: bytes) -> None:
    with tempfile.NamedTemporaryFile(dir=path.parent, delete=False) as f:
        f.write(data)
    os.replace(f.name, path)


def _types_sidecar(path: Union[str, Path]) -> Path:
    return Path(str(path) + ".types.json")


def _strip_addresses(s: str) -> str:
    return re.sub(r"0x[0-9a-fA-F]+", "0x", s)


def _device_key(example_args: tuple) -> str:
    """The device the program's tensors live on, with its capability: a
    program holds its device in the ops that make tensors."""
    for x in pytree.tree_leaves(example_args):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                cap = torch.cuda.get_device_capability(x.device)
                return f"{x.device}:sm{cap[0]}{cap[1]}"
            return str(x.device)
    return "none"


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def bundle_key(example_args: tuple, tag: str = "",
               batch_args: Sequence[int] = ()) -> str:
    """The bundle's key: a hash of the tag (addresses stripped), the torch
    version, the device and its capability, the world size, the tree
    structure and every leaf's shape and dtype (the batch axis of
    ``batch_args``'s tensors written as ``rows`` where its length is in
    ``ROWS``)."""
    example_args = tuple(example_args)
    leaves, spec = pytree.tree_flatten(example_args)
    dynamic = {id(x) for i in batch_args if _dynamic(example_args[i])
               for x in pytree.tree_leaves(example_args[i])}

    def sig(x):
        if not torch.is_tensor(x):
            return f"{type(x).__name__}={x!r}"
        shape = list(x.shape)
        if id(x) in dynamic:
            shape[0] = "rows"
        return f"{shape}:{x.dtype}"

    key_src = "::".join([_strip_addresses(tag), torch.__version__,
                         _device_key(example_args), str(_world_size()),
                         str(spec), "|".join(sig(x) for x in leaves)])
    return hashlib.sha256(key_src.encode()).hexdigest()[:24]


def bundle_or_jit(fn: Callable, example_args: tuple,
                  cache_dir: Union[str, Path], tag: str = "",
                  batch_args: Sequence[int] = ()) -> Callable:
    """A bundle cache around ``fn``.

    Key: ``bundle_key``. On a hit, returns the loaded bundle (no tracing);
    on a miss, exports the bundle for next time and returns ``fn`` itself.
    ``tag`` must capture everything beyond shapes that changes the
    computation (the model's and the config's reprs). The key holds the
    device, its capability and the torch version, so a bundle made for
    another device or another torch is never loaded (where the JAX package
    loads one and falls back when it fails, the port exports anew).

    The cache is keyed by configuration, NOT by code version: delete the
    directory after changing the package's internals."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{bundle_key(example_args, tag, batch_args)}.pt2"
    if not path.exists():
        export_jitted(fn, example_args, path, batch_args)
        return fn
    return load_bundle(path)


def load_bundle(path_or_bytes: Union[str, Path, bytes]) -> Callable:
    """Load a bundle into a callable with ``fn``'s arguments and pytree
    out, without the model's code and without tracing. The flash operators
    and the port's standard node types are registered first; a bundle
    whose manifest names a type not registered in this process raises."""
    _register_fit_types()
    if not isinstance(path_or_bytes, bytes):
        sidecar = _types_sidecar(path_or_bytes)
        if sidecar.exists():
            missing = (set(json.loads(sidecar.read_text()))
                       - _registered_names())
            if missing:
                raise RuntimeError(
                    f"AOT bundle {path_or_bytes} requires pytree node "
                    f"serializations not registered in this process: "
                    f"{sorted(missing)}. Import the defining modules and "
                    "register them (core.aot._register_tree_types on an "
                    "example tree) before load_bundle.")
    source = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
              else Path(path_or_bytes))
    return torch.export.load(source).module()

