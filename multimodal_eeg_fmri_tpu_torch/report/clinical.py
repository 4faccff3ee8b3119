"""Per-fold clinical decision report over a finished CV run (PyTorch).
Counterpart of ``multimodal_eeg_fmri_tpu/report/clinical.py``.

Glues the decision toolkit (calibration, operating point, conformal
coverage) onto the port's `train/cv.CVResult`, which carries every fold's
held-out probabilities/labels/padding mask — so the report is pure math
on stored outputs, no re-evaluation, usable on any protocol the CV
runs produce (SGKF / LOSO / LOOCV / fMRI k-fold). The math runs on
``device``, the card unless the caller asks for another, as the JAX
package's runs on its default device; each value is read back once, as a
float of the report.

Per fold: ECE, Brier, best-F1 operating point. Conformal coverage is
**leave-one-fold-out**: fold f's prediction sets use a q̂ calibrated on
the OTHER folds' held-out outputs (within-fold calibrate-and-test would
be circular). Summary rows are mean ± std across folds, the same form as
``CVResult.summary``.

The reference reports raw fold metrics only (`CrossModal_EEG_scr.ipynb
§44`); this is the framework's deployment-readiness extension.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor, model_device
from multimodal_eeg_fmri_tpu_torch.report.calibration import (
    brier_score,
    expected_calibration_error,
    optimal_threshold,
)
from multimodal_eeg_fmri_tpu_torch.report.conformal import (
    conformal_calibrate,
    conformal_sets,
    coverage_and_size,
)


def clinical_report(
    result,                       # the port's CVResult (binary task)
    alpha: float = 0.1,
    n_bins: int = 10,
    device="cuda",
) -> Dict[str, Dict]:
    """{"per_fold": {name: (n_folds,)}, "summary": {name: (mean, std)}}.

    Requires ``result.test_probs/test_labels/test_weight`` (populated by
    ``run_cv`` for classification) — raises otherwise.
    """
    if result.test_probs is None or result.test_labels is None:
        raise ValueError("CVResult carries no per-sample test outputs — "
                         "clinical_report needs a classification run_cv "
                         "result")
    dev = model_device(device)
    probs = as_tensor(np.asarray(result.test_probs, np.float32), dev)
    labels = as_tensor(np.asarray(result.test_labels, np.int64), dev)
    weight = (as_tensor(np.asarray(result.test_weight, np.float32), dev)
              if result.test_weight is not None
              else torch.ones(labels.shape, dtype=torch.float32, device=dev))
    n_folds = probs.shape[0]

    per: Dict[str, np.ndarray] = {
        k: np.zeros(n_folds, np.float64)
        for k in ("ece", "brier", "opt_threshold", "opt_f1",
                  "conformal_coverage", "conformal_set_size")
    }
    for f in range(n_folds):
        p1, y, w = probs[f, :, 1], labels[f], weight[f]
        per["ece"][f] = float(expected_calibration_error(
            p1, y, n_bins=n_bins, weights=w))
        per["brier"][f] = float(brier_score(p1, y, weights=w))
        t, v = optimal_threshold(p1, y, metric="f1", weights=w)
        per["opt_threshold"][f] = float(t)
        per["opt_f1"][f] = float(v)

        # leave-one-fold-out conformal: q̂ from every OTHER fold's rows.
        # With a single fold there is no other fold — fall back to
        # leave-one-SAMPLE-out within the fold (the pooled-report rule)
        # instead of calibrating on zero rows.
        others = [g for g in range(n_folds) if g != f]
        if others:
            cal_p = probs[others].reshape(-1, probs.shape[-1])
            cal_y = labels[others].reshape(-1)
            cal_w = weight[others].reshape(-1)
            q = conformal_calibrate(cal_p, cal_y, alpha=alpha, weights=cal_w)
            sets = conformal_sets(probs[f], q)
            cov, size = coverage_and_size(sets, y, weights=w)
            per["conformal_coverage"][f] = float(cov)
            per["conformal_set_size"][f] = float(size)
        else:
            m = weight[f] > 0
            cov_f, size_f = _loo_conformal(probs[f][m], labels[f][m], alpha)
            per["conformal_coverage"][f] = cov_f
            per["conformal_set_size"][f] = size_f

    summary: Dict[str, Tuple[float, float]] = {
        k: (float(v.mean()), float(v.std())) for k, v in per.items()
    }
    return {"per_fold": per, "summary": summary, "alpha": alpha}


def pooled_clinical_report(
    probs: np.ndarray,            # (n, C) pooled held-out probabilities
    labels: np.ndarray,           # (n,)
    alpha: float = 0.1,
    n_bins: int = 10,
    device="cuda",
) -> Dict[str, float]:
    """Clinical report for pooled one-row-per-fold protocols (LOOCV/LOSO
    subject predictions), where per-fold calibration is meaningless.

    Conformal coverage here is **leave-one-out**: subject i's q̂ comes from
    every OTHER subject's nonconformity score (the LOOCV analogue of the
    leave-one-fold-out rule; the O(n²) loop is trivial at subject counts).
    """
    dev = model_device(device)
    probs = as_tensor(np.asarray(probs, np.float32), dev)
    labels = as_tensor(np.asarray(labels, np.int64), dev)
    p1, y = probs[:, 1], labels
    t, v = optimal_threshold(p1, y, metric="f1")
    out = {
        "ece": float(expected_calibration_error(p1, y, n_bins=n_bins)),
        "brier": float(brier_score(p1, y)),
        "opt_threshold": float(t),
        "opt_f1": float(v),
        "alpha": alpha,
    }
    cov, size = _loo_conformal(probs, labels, alpha)
    out["conformal_coverage"] = cov
    out["conformal_set_size"] = size
    return out


def _loo_conformal(probs: torch.Tensor, labels: torch.Tensor,
                   alpha: float) -> Tuple[float, float]:
    """Leave-one-out conformal (coverage, mean set size): row i's q̂ comes
    from every other row's LAC score. One (n, n−1) sort on the inputs'
    device, trivial at subject counts."""
    n = labels.shape[0]
    scores = 1.0 - probs.gather(-1, labels[:, None])[:, 0]   # LAC score
    others = scores.expand(n, n)[
        ~torch.eye(n, dtype=torch.bool, device=scores.device)].view(n, n - 1)
    m = n - 1
    rank = min(int(np.ceil((m + 1) * (1 - alpha))), m)
    qhat = torch.sort(others, dim=1).values[:, rank - 1]
    covered = scores <= qhat
    sizes = ((1.0 - probs) <= qhat[:, None]).sum(-1)
    return (float(covered.double().mean()), float(sizes.double().mean()))
