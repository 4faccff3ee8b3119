"""Statistical analysis of CV results (numpy and scipy). A copy of
``multimodal_eeg_fmri_tpu/report/stats.py``; the late-fusion metrics run on
the port's tensor metrics, on the card unless the caller asks for another
device.

Reference: Wilcoxon paired tests across folds + paired t-tests
(``CrossModal_EEG_scr.ipynb §34`` ``perform_statistical_tests``), t-dist
confidence intervals (§28), and probability-averaging late fusion
(``evaluate_late_fusion`` §34).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device
from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    binary_classification_metrics,
)


def paired_tests(
    metrics_a: Sequence[float], metrics_b: Sequence[float]
) -> Dict[str, float]:
    """Wilcoxon signed-rank + paired t-test over per-fold metrics."""
    from scipy.stats import ttest_rel, wilcoxon

    a = np.asarray(metrics_a, np.float64)
    b = np.asarray(metrics_b, np.float64)
    out: Dict[str, float] = {}
    t_stat, t_p = ttest_rel(a, b)
    out["t_stat"], out["t_p"] = float(t_stat), float(t_p)
    try:
        w_stat, w_p = wilcoxon(a, b)
        out["wilcoxon_stat"], out["wilcoxon_p"] = float(w_stat), float(w_p)
    except ValueError:  # all differences zero
        out["wilcoxon_stat"], out["wilcoxon_p"] = 0.0, 1.0
    out["mean_diff"] = float(np.mean(a - b))
    return out


def confidence_interval(
    values: Sequence[float], confidence: float = 0.95
) -> Tuple[float, float, float]:
    """(mean, lo, hi) using the t distribution (reference §28)."""
    from scipy.stats import t

    v = np.asarray(values, np.float64)
    n = len(v)
    mean = float(v.mean())
    if n < 2:
        return mean, mean, mean
    sem = v.std(ddof=1) / np.sqrt(n)
    h = float(sem * t.ppf((1 + confidence) / 2, n - 1))
    return mean, mean - h, mean + h


def compare_models(
    results: Mapping[str, "object"], metric: str = "f1"
) -> Dict[Tuple[str, str], Dict[str, float]]:
    """All-pairs statistical comparison of CVResults on a fold metric."""
    names = list(results)
    out = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            out[(a, b)] = paired_tests(
                results[a].fold_metrics[metric],
                results[b].fold_metrics[metric],
            )
    return out


def late_fusion_probs(
    prob_list: Sequence[np.ndarray], weights: Sequence[float] = None
) -> np.ndarray:
    """Probability-averaging late fusion over models (reference
    ``evaluate_late_fusion``): mean (or weighted mean) of per-model softmax
    probabilities."""
    probs = np.stack([np.asarray(p) for p in prob_list])
    if weights is None:
        return probs.mean(0)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return np.einsum("m,m...->...", w, probs)


def evaluate_late_fusion(
    results: Mapping[str, "object"],
    model_names: Sequence[str],
    weights: Sequence[float] = None,
    device="cuda",
) -> Dict[str, float]:
    """Pool fold test sets, average class probabilities across the named
    models, compute the metric dict on ``device``."""
    dev = model_device(device)
    first = results[model_names[0]]
    fold_metrics = []
    for f in range(first.n_folds):
        mask = first.test_weight[f] > 0
        fused = late_fusion_probs(
            [results[m].test_probs[f][mask] for m in model_names], weights)
        labels = first.test_labels[f][mask]
        logits = np.log(np.maximum(fused, 1e-9))
        m = binary_classification_metrics(
            torch.from_numpy(logits).to(dev), torch.from_numpy(labels).to(dev))
        fold_metrics.append({k: float(v) for k, v in m.items()})
    return {
        k: float(np.mean([fm[k] for fm in fold_metrics]))
        for k in fold_metrics[0]
    }
