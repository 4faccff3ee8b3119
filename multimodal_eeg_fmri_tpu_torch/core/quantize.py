"""Weight-only int8 and int4 payloads (numpy). Counterpart of
``multimodal_eeg_fmri_tpu/core/quantize.py``, with the same functions and
the same ``.npz`` format, so that a payload written by either package loads
in the other.

The payload holds flax-layout variable trees (nested dicts of numpy arrays:
kernels ``(in..., out)``, convolution kernels ``(K, Cin, Cout)``), as
``convert.flax_variables_from_module`` gives them for a port module and
``convert.load_flax_variables`` takes them back. The layout matters: int8
scales run along the last axis, and int4 groups along the flattened input
axes, so the same weights in torch's ``(out, in, ...)`` layout would give
other scales and other groups.

- int8: symmetric per-output-channel, ``s = max|w| / 127`` over the last
  axis.
- int4: symmetric, the input axes flattened to rows and cut into groups of
  ``group_size``, one scale ``max|w| / 7`` per (group, output channel),
  two nibbles a byte.
- Leaves below 2-D, non-float leaves and biases (``bias``, ``b1``, ``b2``,
  which are 2-D in multi-head projections) stay f32, as do all collections
  other than ``params``. Weights dequantize at load; compute stays f32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np

_SEP = "/"  # flattened-path key separator inside the npz


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    """Nested dicts to {path tuple: leaf}, in insertion order, empty dicts
    dropped (flax's ``flatten_dict``, which the card does not have)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def quantize_leaf(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-last-axis-channel int8. Returns (q, scales) with
    ``q.shape == w.shape`` (int8) and ``scales.shape == (w.shape[-1],)``."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return q, scales


def dequantize_leaf(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scales


def quantize_leaf_int4(
    w: np.ndarray, group_size: int = 64
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    """Symmetric grouped int4 over the flattened input axes; returns
    (packed uint8 (ceil(G·group_size / 2), out), scales (G, out), shape).
    Nibbles are stored as q + 8, two a byte, the even row in the high
    nibble."""
    w = np.asarray(w, np.float32)
    out_ch = w.shape[-1]
    rows = w.reshape(-1, out_ch)
    n = rows.shape[0]
    n_groups = -(-n // group_size)
    pad = n_groups * group_size - n
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, out_ch), np.float32)])
    g = rows.reshape(n_groups, group_size, out_ch)
    amax = np.max(np.abs(g), axis=1)                       # (G, out)
    scales = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(g / scales[:, None, :]), -7, 7).astype(np.int8)
    q = q.reshape(n_groups * group_size, out_ch)
    nib = (q + 8).astype(np.uint8)                         # 1..15
    if nib.shape[0] % 2:
        nib = np.concatenate([nib, np.zeros((1, out_ch), np.uint8)])
    packed = (nib[0::2] << 4) | nib[1::2]
    return packed, scales, w.shape


def dequantize_leaf_int4(packed: np.ndarray, scales: np.ndarray,
                         shape: Tuple[int, ...],
                         group_size: int = 64) -> np.ndarray:
    out_ch = packed.shape[-1]
    hi = (packed >> 4).astype(np.int8) - 8
    lo = (packed & 0x0F).astype(np.int8) - 8
    nib = np.empty((packed.shape[0] * 2, out_ch), np.int8)
    nib[0::2], nib[1::2] = hi, lo
    n = int(np.prod(shape[:-1]))
    n_groups = scales.shape[0]
    q = nib[: n_groups * group_size].reshape(n_groups, group_size, out_ch)
    w = (q.astype(np.float32) * scales[:, None, :]).reshape(-1, out_ch)
    return w[:n].reshape(shape)


# biases that are 2-D or more: multi-head projections store theirs as
# (num_heads, head_dim), the MoE experts as b1 (E, ff) and b2 (E, D)
_BIAS_NAMES = frozenset({"bias", "b1", "b2"})


def _quantizable(leaf, name: str | None = None) -> bool:
    a = np.asarray(leaf)
    if name is not None and name in _BIAS_NAMES:
        return False
    return a.ndim >= 2 and np.issubdtype(a.dtype, np.floating)


def quantize_tree(params: Any) -> Tuple[Any, Any]:
    """(params) → (quantized tree, scales tree). Leaves that do not qualify
    pass through with scale None."""
    qt, st = {}, {}
    for path, leaf in _flatten(params).items():
        if _quantizable(leaf, path[-1]):
            qt[path], st[path] = quantize_leaf(np.asarray(leaf))
        else:
            qt[path], st[path] = np.asarray(leaf), None
    return _unflatten(qt), _unflatten(st)


def dequantize_tree(qtree: Any, stree: Any) -> Any:
    sf = _flatten(stree)
    return _unflatten({path: q if sf[path] is None
                       else dequantize_leaf(q, sf[path])
                       for path, q in _flatten(qtree).items()})


def save_quantized(path: str | Path, variables: Dict[str, Any],
                   bits: int = 8, group_size: int = 64) -> Path:
    """Quantize ``variables['params']`` (weight-only) and write one ``.npz``
    with every other collection (batch_stats, ...) stored f32 as it is.
    ``bits=8``: per-output-channel int8 (~4× smaller); ``bits=4``: grouped
    int4 (~8× smaller)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"collections": sorted(variables),
                                "bits": bits, "group_size": group_size,
                                "shapes": {}}
    for col, tree in variables.items():
        for p, leaf in _flatten(tree).items():
            key = _SEP.join((col,) + p)
            leaf = np.asarray(leaf)
            if col == "params" and _quantizable(leaf, p[-1]):
                if bits == 8:
                    q, s = quantize_leaf(leaf)
                    arrays["q" + _SEP + key] = q
                else:
                    q, s, shape = quantize_leaf_int4(leaf, group_size)
                    arrays["p" + _SEP + key] = q
                    manifest["shapes"][key] = list(shape)
                arrays["s" + _SEP + key] = s
            else:
                arrays["f" + _SEP + key] = leaf
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, __manifest__=json.dumps(manifest), **arrays)
    return path


def load_quantized(path: str | Path) -> Dict[str, Any]:
    """Load and dequantize a ``save_quantized`` payload to f32 flax-layout
    variables, ready for ``convert.load_flax_variables``."""
    with np.load(Path(path), allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        gs = int(manifest.get("group_size", 64))
        shapes = manifest.get("shapes", {})
        flat: Dict[Tuple[str, ...], np.ndarray] = {}
        for name in z.files:
            if name == "__manifest__" or name.startswith("s" + _SEP):
                continue
            kind, key = name.split(_SEP, 1)
            path_t = tuple(key.split(_SEP))
            if kind == "q":
                flat[path_t] = dequantize_leaf(z[name], z["s" + _SEP + key])
            elif kind == "p":  # packed int4
                flat[path_t] = dequantize_leaf_int4(
                    z[name], z["s" + _SEP + key], tuple(shapes[key]), gs)
            else:
                flat[path_t] = z[name]
    tree = _unflatten(flat)
    return {col: tree.get(col, {}) for col in manifest["collections"]}
