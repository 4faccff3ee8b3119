"""Determinism harness. Counterpart of
``multimodal_eeg_fmri_tpu/core/determinism.py``: run a callable twice on
the same inputs and require the two results to agree leaf for leaf, bit
for bit by default. It catches nondeterministic reductions (atomics in
another order), a generator read where none should be, and state carried
from one call into the next. On a card, bitwise agreement of some
reductions needs ``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _leaves(x: Any, path: str = "") -> Tuple[List[Tuple[str, Any]], Any]:
    """(path, leaf) pairs and a structure signature of a nest of dicts,
    lists and tuples."""
    if isinstance(x, dict):
        pairs, sig = [], []
        for k in sorted(x):
            p, s = _leaves(x[k], f"{path}/{k}")
            pairs += p
            sig.append((k, s))
        return pairs, ("dict", tuple(sig))
    if isinstance(x, (list, tuple)):
        pairs, sig = [], []
        for i, v in enumerate(x):
            p, s = _leaves(v, f"{path}[{i}]")
            pairs += p
            sig.append(s)
        return pairs, (type(x).__name__, tuple(sig))
    return [(path or "leaf", x)], "leaf"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def run_twice_and_compare(fn: Callable, *args, atol: float = 0.0,
                          **kwargs) -> bool:
    """Execute ``fn`` twice with identical inputs; raise AssertionError on
    any mismatch in structure or values. ``atol=0`` demands bitwise
    equality (NaNs equal)."""
    leaves_a, tree_a = _leaves(fn(*args, **kwargs))
    leaves_b, tree_b = _leaves(fn(*args, **kwargs))
    if tree_a != tree_b:
        raise AssertionError(f"output structure differs: {tree_a} vs {tree_b}")
    for (path, x), (_, y) in zip(leaves_a, leaves_b):
        x, y = _host(x), _host(y)
        if atol == 0.0:
            if not np.array_equal(x, y, equal_nan=True):
                raise AssertionError(
                    f"{path}: bitwise mismatch "
                    f"(max |Δ| = {np.max(np.abs(x - y))})")
        else:
            np.testing.assert_allclose(x, y, atol=atol)
    return True
