"""Array-dataset helpers (numpy). The port's copy of the part of
``multimodal_eeg_fmri_tpu/data/arrays.py`` that its training uses, and
``as_tensor``, which moves an array to the device as the JAX package's
``jnp.asarray`` would convert it, and ``model_device``, which resolves the
device an entry point runs on.

Datasets are dicts of arrays with a leading sample axis and a ``weight``
mask (1 = real row, 0 = padding), so that folds of other sizes pad to one
shape and the mask removes the padding from losses and metrics.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np
import torch

Dataset = Dict[str, np.ndarray]

log = logging.getLogger("multimodal_eeg_fmri_tpu_torch.data")


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """An array or a tensor of any device, on ``device``; float64 becomes
    float32, as the JAX package (x64 off) makes it."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    return t.to(device=device, dtype=dtype)


def model_device(device) -> torch.device:
    """The device a public model or featurizer works on. The port's entry
    points default to the card; without one that default raises instead of
    running on the CPU, which a caller must ask for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's models build on the GPU by default; "
            "pass device='cpu' to build on the CPU")
    return device


def subset(data: Dataset, idx: Sequence[int]) -> Dataset:
    idx = np.asarray(idx)
    return {k: np.asarray(v)[idx] for k, v in data.items()}


def pad_rows(data: Dataset, target: int) -> Dataset:
    """Pad every leaf to ``target`` rows; pad rows get weight 0. Padding
    rows cycle through the dataset (row i % n), so that the BatchNorm
    statistics of a padded batch stay representative."""
    n = len(next(iter(data.values())))
    if "weight" not in data:
        data = {**data, "weight": np.ones((n,), np.float32)}
    if n == target:
        return data
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    idx = np.arange(target - n) % n
    out = {}
    for k, v in data.items():
        v = np.asarray(v)
        pad = np.zeros_like(v[idx]) if k == "weight" else v[idx]
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def validate_dataset(data: Dataset, *, require_label: bool = True,
                     num_classes: int = 2, batch_size: int = None,
                     name: str = "dataset",
                     warn_missing_weight: bool = True) -> Dataset:
    """Check a user-built dataset dict on the host, with messages that name
    the key at fault; returns the dataset unchanged.

    Checks: a dict of arrays with one shared leading sample axis; an integer
    ``label`` in ``[0, num_classes)``; a ``weight`` (if present) that is a
    non-negative 1-D float mask. Warns on non-finite values, float64 leaves
    and a batch size that drops rows."""
    if not isinstance(data, dict) or not data:
        raise ValueError(
            f"{name} must be a non-empty dict of arrays keyed by modality "
            f"(e.g. {{'erp': (n,T,18), 'pw': (n,T,75), 'conn': (n,459), "
            f"'label': (n,), 'weight': (n,)}}), got {type(data).__name__}")
    arrays = {}
    for k, v in data.items():
        try:
            arrays[k] = np.asarray(v)
        except (TypeError, ValueError, RuntimeError) as e:
            raise ValueError(
                f"{name}[{k!r}] is not array-convertible: {e}") from e
        if arrays[k].ndim == 0:
            raise ValueError(
                f"{name}[{k!r}] is a scalar — every entry needs a leading "
                f"sample axis (shape (n, ...))")
    sizes = {k: len(v) for k, v in arrays.items()}
    if len(set(sizes.values())) > 1:
        raise ValueError(
            f"{name} entries disagree on the sample count: {sizes} — all "
            f"leaves must share the leading axis")
    n = next(iter(sizes.values()))
    if require_label:
        if "label" not in arrays:
            raise ValueError(
                f"{name} has no 'label' entry (keys: {sorted(arrays)}); "
                f"training data needs integer labels in [0, {num_classes})")
        lab = arrays["label"]
        if not np.issubdtype(lab.dtype, np.integer):
            raise ValueError(
                f"{name}['label'] has dtype {lab.dtype}; cast to an integer "
                f"type (e.g. labels.astype(np.int64)) — float labels are a "
                f"classification/regression mixup")
        if lab.ndim != 1:
            raise ValueError(
                f"{name}['label'] must be 1-D (n,), got shape {lab.shape}")
        if n and (lab.min() < 0 or lab.max() >= num_classes):
            raise ValueError(
                f"{name}['label'] values span [{lab.min()}, {lab.max()}] "
                f"but num_classes={num_classes}; remap labels to "
                f"[0, {num_classes})")
    if "weight" in arrays:
        w = arrays["weight"]
        if w.ndim != 1 or not np.issubdtype(w.dtype, np.floating):
            raise ValueError(
                f"{name}['weight'] must be a 1-D float mask (1=real row, "
                f"0=padding), got dtype {w.dtype} shape {w.shape}; "
                f"pad_rows() builds it for you")
        if n and w.min() < 0:
            raise ValueError(f"{name}['weight'] has negative entries "
                             f"(min {w.min()}) — weights are multiplicative "
                             f"loss masks and must be >= 0")
    elif require_label and warn_missing_weight:
        log.warning(
            "%s has no 'weight' column; add np.ones((%d,), np.float32) "
            "(or use pad_rows) — losses/metrics mask padding through it",
            name, n)
    for k, v in arrays.items():
        if np.issubdtype(v.dtype, np.floating):
            if v.dtype == np.float64:
                log.warning("%s[%r] is float64; training casts it to "
                            "float32", name, k)
            if not np.isfinite(v).all():
                bad = int((~np.isfinite(v)).sum())
                log.warning(
                    "%s[%r] has %d non-finite value(s); NaN propagates to "
                    "NaN loss — scrub at ingest (np.nan_to_num)", name, k,
                    bad)
    if batch_size and n % batch_size:
        log.warning(
            "%s: %d rows with batch_size=%d drops the last %d row(s) each "
            "epoch (fit runs n // batch_size full batches); pad_rows(%d) "
            "keeps them with zero-weight padding",
            name, n, batch_size, n % batch_size,
            ((n + batch_size - 1) // batch_size) * batch_size)
    return data


def balanced_class_weights(labels: np.ndarray, num_classes: int = 2,
                           weights: np.ndarray = None) -> np.ndarray:
    """sklearn ``compute_class_weight('balanced')``: n / (k · bincount)."""
    labels = np.asarray(labels)
    if weights is not None:
        labels = labels[np.asarray(weights) > 0]
    counts = np.maximum(np.bincount(labels, minlength=num_classes), 1)
    return (len(labels) / (num_classes * counts.astype(np.float64))).astype(
        np.float32)
