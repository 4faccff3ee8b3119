"""Synthetic dataset fixtures (numpy). A copy of
``multimodal_eeg_fmri_tpu/data/synthetic.py``: the same seeds give the same
arrays, so the port and the JAX package train on the same cohorts.

The reference's own smoke tests build random tensors with the production
shapes (``enhanced_models_v4.py:844-890``: ERP (B,C,T), PW (B,C,T), conn
matrices; ``_test_bridge.py:710-727``: random 128/64-d embeddings). These
generators produce the same shapes (channels-last) with an optional
*separable* class signal so integration tests can assert
loss-decreases / accuracy-above-chance, and the lite pipeline runs
end-to-end with zero file I/O.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _labels(n: int, rng: np.random.Generator) -> np.ndarray:
    y = np.zeros(n, np.int32)
    y[: n // 2] = 1
    rng.shuffle(y)
    return y


def synthetic_eeg_trimodal(
    n_subjects: int = 66,
    erp_channels: int = 18,
    pw_channels: int = 75,
    conn_features: int = 459,
    time_steps: int = 250,
    separation: float = 1.0,
    seed: int = 0,
    conn_as_matrix: bool = False,
    n_nodes: int = 18,
    n_metrics: int = 3,
) -> Dict[str, np.ndarray]:
    """Tri-modal EEG dataset: {'erp': (N,T,Ce), 'pw': (N,T,Cp),
    'conn': (N,F) or (N,n,n,m), 'label': (N,), 'subject': (N,)}.

    ``separation`` injects a class-dependent mean shift into each modality
    (0 → pure noise, chance-level task)."""
    rng = np.random.default_rng(seed)
    y = _labels(n_subjects, rng)
    shift = (y * 2 - 1)[:, None, None] * separation

    erp = rng.standard_normal((n_subjects, time_steps, erp_channels)).astype(np.float32)
    erp += 0.3 * shift * np.sin(
        np.linspace(0, 4 * np.pi, time_steps)
    )[None, :, None].astype(np.float32)

    pw = rng.standard_normal((n_subjects, time_steps, pw_channels)).astype(np.float32)
    pw += 0.3 * shift

    if conn_as_matrix:
        base = rng.uniform(0, 1, (n_subjects, n_nodes, n_nodes, n_metrics))
        base = (base + base.transpose(0, 2, 1, 3)) / 2
        base += 0.1 * separation * (y * 2 - 1)[:, None, None, None]
        conn = np.clip(base, 0, 1).astype(np.float32)
    else:
        conn = rng.standard_normal((n_subjects, conn_features)).astype(np.float32)
        conn += 0.3 * separation * (y * 2 - 1)[:, None]

    return {
        "erp": erp,
        "pw": pw,
        "conn": conn,
        "label": y,
        "subject": np.arange(1, n_subjects + 1, dtype=np.int32),
    }


def synthetic_fmri(
    n_subjects: int = 32,
    activation_dim: int = 90,   # 5 types × (mean+std of 9 ROIs) in reference
    connectivity_dim: int = 64,
    separation: float = 1.0,
    seed: int = 0,
    with_regression: bool = True,
) -> Dict[str, np.ndarray]:
    """Bi-modal fMRI dataset: {'activation', 'connectivity', 'label',
    'reg_label', 'subject'}."""
    rng = np.random.default_rng(seed)
    y = _labels(n_subjects, rng)
    act = rng.standard_normal((n_subjects, activation_dim)).astype(np.float32)
    act += 0.4 * separation * (y * 2 - 1)[:, None]
    conn = rng.standard_normal((n_subjects, connectivity_dim)).astype(np.float32)
    conn += 0.4 * separation * (y * 2 - 1)[:, None]
    data = {
        "activation": act,
        "connectivity": conn,
        "label": y,
        "subject": np.arange(1, n_subjects + 1, dtype=np.int32),
    }
    if with_regression:
        data["reg_label"] = (
            y.astype(np.float32) * separation
            + 0.5 * rng.standard_normal(n_subjects).astype(np.float32)
        )
    return data


def synthetic_bridge(
    n_subjects: int = 32,
    eeg_dim: int = 128,
    fmri_dim: int = 64,
    separation: float = 1.0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Bridge-stage dataset of frozen-encoder embeddings."""
    rng = np.random.default_rng(seed)
    y = _labels(n_subjects, rng)
    eeg = rng.standard_normal((n_subjects, eeg_dim)).astype(np.float32)
    eeg += 0.4 * separation * (y * 2 - 1)[:, None]
    fmri = rng.standard_normal((n_subjects, fmri_dim)).astype(np.float32)
    fmri += 0.4 * separation * (y * 2 - 1)[:, None]
    return {
        "eeg": eeg,
        "fmri": fmri,
        "label": y,
        "subject": np.arange(1, n_subjects + 1, dtype=np.int32),
    }
