"""Tree helpers. Counterpart of ``multimodal_eeg_fmri_tpu/utils/tree.py``.

A tree here is an ``nn.Module`` (its parameters, or with ``cast_floating``
its parameters and buffers), or a tensor, a numpy array or a dict, list or
tuple of them, nested (a state dict, a flax variable dict converted to
numpy). ``count_parameters`` is the reference utility
(``crossmodal_v4_enhancements.py:606-608``); the rest serve mixed precision
and memory accounting.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any) -> List:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _itemsize(x) -> int:
    return x.element_size() if torch.is_tensor(x) else x.dtype.itemsize


def count_parameters(params: Any) -> int:
    """Total number of elements across a module's parameters or a tree."""
    return sum(int(x.numel() if torch.is_tensor(x) else x.size)
               for x in _leaves(params))


def tree_size_bytes(tree: Any) -> int:
    return sum(int((x.numel() if torch.is_tensor(x) else x.size)
                   * _itemsize(x)) for x in _leaves(tree))


def cast_floating(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Floating-point leaves cast to ``dtype`` (inputs and activations for
    bf16 compute), numpy arrays becoming tensors (numpy has no bf16);
    integer leaves pass through. A module is cast in place (its floating
    parameters and buffers) and returned."""
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
        return tree
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, np.ndarray):
        if not np.issubdtype(tree.dtype, np.floating):
            return tree
        return torch.as_tensor(tree).to(dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree
