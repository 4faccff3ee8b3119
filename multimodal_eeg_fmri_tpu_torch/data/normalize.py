"""Leakage-safe per-fold normalization (host-side numpy). A copy of
``multimodal_eeg_fmri_tpu/data/normalize.py``.

Reference ``PerFoldNormalizer`` (``CrossModal_EEG_scr.ipynb §19``): one
global scalar mean/std per modality, fit on the training indices only, then
applied to the whole fold's data. Also the simpler ``normalize_modality``
(``run_training_lite.py:48-51``) and fMRI StandardScaler usage. Both run
once per fold on the host, before the fold's data moves to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np


@dataclass
class FoldNormalizer:
    """Scalar z-score per modality key, fit on train rows only."""

    keys: Sequence[str]
    eps: float = 1e-8
    stats: Dict[str, tuple] = field(default_factory=dict)

    def fit(self, data: Dict[str, np.ndarray], train_idx: np.ndarray):
        for k in self.keys:
            x = np.asarray(data[k])[train_idx].astype(np.float64)
            self.stats[k] = (float(x.mean()), float(x.std() + self.eps))
        return self

    def transform(self, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(data)
        for k in self.keys:
            mean, std = self.stats[k]
            out[k] = ((np.asarray(data[k]) - mean) / std).astype(np.float32)
        return out

    def fit_transform(self, data, train_idx):
        return self.fit(data, train_idx).transform(data)


def feature_standardize(
    data: Dict[str, np.ndarray],
    train_idx: np.ndarray,
    keys: Sequence[str],
    eps: float = 1e-8,
) -> Dict[str, np.ndarray]:
    """Per-feature StandardScaler semantics (fMRI pipeline): mean/std per
    column, fit on train rows only."""
    out = dict(data)
    for k in keys:
        x = np.asarray(data[k])
        mu = x[train_idx].mean(axis=0, keepdims=True)
        sd = x[train_idx].std(axis=0, keepdims=True) + eps
        out[k] = ((x - mu) / sd).astype(np.float32)
    return out
