"""Subject data handling (PyTorch port): aggregation, alignment, padding,
degradation. Counterpart of ``multimodal_eeg_fmri_tpu/data/handler.py``,
copied (numpy only).

Unifies the reference's three SubjectDataHandlers (EEG
``CrossModal_EEG_scr.ipynb §17``, fMRI ``CrossModal_fmri_scr.ipynb §4``,
bridge ``CrossModal_Bridge_EEG-fMRI_scr.ipynb §15``) and the dataset joiners
(``TriModalDataset`` §18, ``BalancedTriModalDataset``
``crossmodal_v4_enhancements.py:955-1077``, ``BridgeRawDataset``
``_test_bridge.py:391-462``) into one array-producing pipeline:

feature dicts keyed by (subject, band, …) → per-subject aggregation
(mean/max over samples, reference ``aggregate_features``) → time-axis
pad-or-truncate to a fixed bucket → subject intersection with labels →
zero-pad missing modalities to the reference shape ("graceful degradation",
``_test_bridge.py:415-421``) → channels-last numpy arrays.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Mapping, Optional

import numpy as np

logger = logging.getLogger(__name__)


def pad_or_truncate_time(x: np.ndarray, time_steps: int,
                         time_axis: int = -1) -> np.ndarray:
    """Fix the time axis to ``time_steps`` (pad with zeros / truncate) —
    reference pad_or_truncate (``CrossModal_EEG_scr.ipynb §4,10``)."""
    T = x.shape[time_axis]
    if T == time_steps:
        return x
    if T > time_steps:
        sl = [slice(None)] * x.ndim
        sl[time_axis] = slice(0, time_steps)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[time_axis if time_axis >= 0 else x.ndim + time_axis] = (
        0, time_steps - T)
    return np.pad(x, pad)


def _subject_of(key) -> int:
    return int(key[0]) if isinstance(key, tuple) else int(key)


def aggregate_by_subject(
    features: Mapping, method: str = "mean"
) -> Dict[int, np.ndarray]:
    """Collapse multi-sample feature dicts {(subj, band, …): array} to one
    array per subject (mean/max over samples — reference
    ``aggregate_features`` / ``BalancedTriModalDataset._aggregate_by_subject``).
    Samples of differing shape are aligned by trimming to the common
    minimal shape before stacking."""
    per_subj = defaultdict(list)
    for key, value in features.items():
        arr = value[0] if isinstance(value, tuple) else value
        per_subj[_subject_of(key)].append(np.asarray(arr, np.float32))

    out: Dict[int, np.ndarray] = {}
    for subj, arrs in per_subj.items():
        if len({a.shape for a in arrs}) > 1:
            mins = tuple(min(a.shape[d] for a in arrs)
                         for d in range(arrs[0].ndim))
            arrs = [a[tuple(slice(0, m) for m in mins)] for a in arrs]
        stacked = np.stack(arrs)
        if method == "mean":
            out[subj] = stacked.mean(0)
        elif method == "max":
            out[subj] = stacked.max(0)
        elif method == "first":
            out[subj] = stacked[0]
        else:
            raise ValueError(f"unknown aggregation {method!r}")
    return out


def samples_by_subject(features: Mapping) -> Dict[int, list]:
    """Sample-level grouping (for LOSO voting / BridgeRawDataset mode)."""
    per_subj = defaultdict(list)
    for key, value in features.items():
        arr = value[0] if isinstance(value, tuple) else value
        per_subj[_subject_of(key)].append(np.asarray(arr, np.float32))
    return dict(per_subj)


def _coerce_temporal(x: np.ndarray, channels: int, time_steps: int
                     ) -> np.ndarray:
    """Bring a raw feature array to channels-last (T, C): accepts (C, T)
    (reference layout), (T, C), or flat vectors reshaped to (C, -1)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        if x.size % channels == 0:
            x = x.reshape(channels, -1)
        else:
            x = np.tile(x[None, :], (channels, 1))
    if x.ndim != 2:
        x = x.reshape(x.shape[0], -1)
    # disambiguate orientation: the reference stores (channels, time)
    if x.shape[0] == channels:
        pass
    elif x.shape[1] == channels:
        x = x.T
    x = pad_or_truncate_time(x, time_steps, time_axis=-1)
    if x.shape[0] != channels:
        x = pad_or_truncate_time(x, channels, time_axis=0)
    return x.T  # → (T, C) channels-last


def _coerce_flat(x: np.ndarray, dim: int) -> np.ndarray:
    x = np.asarray(x, np.float32).flatten()
    if x.size >= dim:
        return x[:dim]
    return np.pad(x, (0, dim - x.size))


def build_trimodal_arrays(
    erp_features: Mapping,
    pw_features: Mapping,
    conn_features: Mapping,
    labels: Mapping[int, int],
    *,
    erp_channels: int = 18,
    pw_channels: int = 75,
    conn_dim: int = 459,
    time_steps: int = 250,
    aggregate: str = "mean",
    require_all: bool = False,
) -> Dict[str, np.ndarray]:
    """Join the three EEG modalities + labels into fixed-shape arrays.

    Subjects present in labels and at least one modality are kept; missing
    modalities are zero-padded to the reference shape (graceful degradation)
    unless ``require_all``. Returns {'erp': (N,T,Ce), 'pw': (N,T,Cp),
    'conn': (N,F), 'label': (N,), 'subject': (N,)}.
    """
    erp_by = aggregate_by_subject(erp_features, aggregate)
    pw_by = aggregate_by_subject(pw_features, aggregate)
    conn_by = aggregate_by_subject(conn_features, aggregate)

    modality_subjects = set(erp_by) | set(pw_by) | set(conn_by)
    if require_all:
        modality_subjects = set(erp_by) & set(pw_by) & set(conn_by)
    subjects = sorted(modality_subjects & {int(s) for s in labels})
    if not subjects:
        raise ValueError("no subjects with labels + features after alignment")

    erp_rows, pw_rows, conn_rows, y = [], [], [], []
    degraded = 0
    for s in subjects:
        if s in erp_by:
            erp_rows.append(_coerce_temporal(erp_by[s], erp_channels,
                                             time_steps))
        else:
            erp_rows.append(np.zeros((time_steps, erp_channels), np.float32))
            degraded += 1
        if s in pw_by:
            pw_rows.append(_coerce_temporal(pw_by[s], pw_channels,
                                            time_steps))
        else:
            pw_rows.append(np.zeros((time_steps, pw_channels), np.float32))
            degraded += 1
        if s in conn_by:
            conn_rows.append(_coerce_flat(conn_by[s], conn_dim))
        else:
            conn_rows.append(np.zeros((conn_dim,), np.float32))
            degraded += 1
        y.append(int(labels[s]))
    if degraded:
        logger.warning("zero-padded %d missing modality entries", degraded)
    logger.info("trimodal dataset: %d subjects", len(subjects))
    return {
        "erp": np.stack(erp_rows),
        "pw": np.stack(pw_rows),
        "conn": np.stack(conn_rows),
        "label": np.asarray(y, np.int32),
        "subject": np.asarray(subjects, np.int32),
    }


def build_fmri_arrays(
    activation: Mapping[int, np.ndarray],
    connectivity: Mapping[int, np.ndarray],
    class_labels: Mapping[int, int],
    reg_labels: Optional[Mapping[int, float]] = None,
) -> Dict[str, np.ndarray]:
    """fMRI dataset join (reference ``fMRIDataset`` subject intersection)."""
    subjects = sorted(set(activation) & set(connectivity)
                      & {int(s) for s in class_labels})
    if not subjects:
        raise ValueError("no complete fMRI subjects")
    data = {
        "activation": np.stack([np.asarray(activation[s], np.float32)
                                for s in subjects]),
        "connectivity": np.stack([np.asarray(connectivity[s], np.float32)
                                  for s in subjects]),
        "label": np.asarray([class_labels[s] for s in subjects], np.int32),
        "subject": np.asarray(subjects, np.int32),
    }
    if reg_labels:
        data["reg_label"] = np.asarray(
            [float(reg_labels.get(s, 0.0)) for s in subjects], np.float32)
    logger.info("fMRI dataset: %d subjects", len(subjects))
    return data


def build_sample_level_arrays(
    erp_features: Mapping,
    pw_features: Mapping,
    conn_features: Mapping,
    labels: Mapping[int, int],
    *,
    erp_channels: int = 18,
    pw_channels: int = 75,
    conn_dim: int = 459,
    time_steps: int = 250,
) -> Dict[str, np.ndarray]:
    """Sample-level tri-modal arrays: one row per EEG sample with the
    subject's conn (open→close fallback handled upstream by cond ordering)
    repeated — the granularity the reference LOSO voter operates on."""
    erp_s = samples_by_subject(erp_features)
    pw_s = samples_by_subject(pw_features)
    conn_by = aggregate_by_subject(conn_features, "mean")
    subjects = sorted((set(erp_s) | set(pw_s)) & {int(s) for s in labels})

    rows = {"erp": [], "pw": [], "conn": [], "label": [], "subject": []}
    for s in subjects:
        erp_list = erp_s.get(s, [])
        pw_list = pw_s.get(s, [])
        n = max(len(erp_list), len(pw_list), 1)
        for i in range(n):
            rows["erp"].append(_coerce_temporal(
                erp_list[i % len(erp_list)], erp_channels, time_steps)
                if erp_list else np.zeros((time_steps, erp_channels),
                                          np.float32))
            rows["pw"].append(_coerce_temporal(
                pw_list[i % len(pw_list)], pw_channels, time_steps)
                if pw_list else np.zeros((time_steps, pw_channels),
                                         np.float32))
            rows["conn"].append(
                _coerce_flat(conn_by[s], conn_dim) if s in conn_by
                else np.zeros((conn_dim,), np.float32))
            rows["label"].append(int(labels[s]))
            rows["subject"].append(s)
    return {
        "erp": np.stack(rows["erp"]),
        "pw": np.stack(rows["pw"]),
        "conn": np.stack(rows["conn"]),
        "label": np.asarray(rows["label"], np.int32),
        "subject": np.asarray(rows["subject"], np.int32),
    }
