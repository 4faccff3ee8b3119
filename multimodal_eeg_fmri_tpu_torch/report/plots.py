"""Matplotlib reporting (host-side, agg backend). Counterpart of
``multimodal_eeg_fmri_tpu/report/plots.py``, copied; matplotlib, scipy and
sklearn are imported inside the functions that draw, so that importing the
module needs none of them. The calibration plots compute on the CPU with
the port's ``report/calibration.py``.

Reference plot inventory (SURVEY §1 L6): model-comparison bars with error
bars, per-fold metric lines, fusion-weight bars, ROC curves, confusion
matrices, t-SNE embeddings of fused features, channel-importance bars,
topomaps, connectivity matrices
(``run_fmri_v11.py:551-687``, ``CrossModal_EEG_scr.ipynb §26,28,32-36``,
``_test_bridge.py:992-1081``, ``eeg_xai_analysis.py:700-871``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _cpu(x):
    """An array as a CPU tensor, where the calibration functions compute."""
    return torch.as_tensor(np.asarray(x))


def plot_model_comparison(results: Mapping[str, object], metric: str = "f1",
                          path: str | Path = "model_comparison.png"):
    plt = _plt()
    names = list(results)
    means = [results[m].summary[metric][0] for m in names]
    stds = [results[m].summary[metric][1] for m in names]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(names, means, yerr=stds, capsize=4)
    ax.set_ylabel(metric)
    ax.set_title(f"Model comparison ({metric}, mean ± std over folds)")
    ax.set_ylim(0, 1)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_fold_metrics(result, metrics: Sequence[str] = ("accuracy", "f1"),
                      path: str | Path = "fold_metrics.png"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for m in metrics:
        ax.plot(result.fold_metrics[m], marker="o", label=m)
    ax.set_xlabel("fold")
    ax.legend()
    ax.set_ylim(0, 1)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_training_history(result, fold: int = 0,
                          keys: Sequence[str] = ("train_loss",),
                          path: str | Path = "history.png"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in keys:
        ax.plot(np.asarray(result.history[k])[fold], label=k)
    ax.set_xlabel("epoch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_fusion_weights(weights: np.ndarray, names: Sequence[str],
                        path: str | Path = "fusion_weights.png"):
    """Bar chart of mean fusion weights (fixes the reference's
    set_xticks-vs-set_xticklabels bug noted in SURVEY §2.5)."""
    plt = _plt()
    w = np.asarray(weights)
    mean = w.mean(0) if w.ndim == 2 else w
    fig, ax = plt.subplots(figsize=(5, 4))
    x = np.arange(len(names))
    ax.bar(x, mean)
    ax.set_xticks(x)
    ax.set_xticklabels(list(names))
    ax.set_ylabel("fusion weight")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_roc(probs1: np.ndarray, labels: np.ndarray,
             path: str | Path = "roc.png"):
    from sklearn.metrics import auc, roc_curve

    plt = _plt()
    fpr, tpr, _ = roc_curve(labels, probs1)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(fpr, tpr, label=f"AUC = {auc(fpr, tpr):.3f}")
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_reliability(probs1: np.ndarray, labels: np.ndarray,
                     n_bins: int = 10,
                     path: str | Path = "reliability.png"):
    """Reliability diagram + per-bin counts (report/calibration data)."""
    from multimodal_eeg_fmri_tpu_torch.report.calibration import (
        expected_calibration_error,
        reliability_curve,
    )

    plt = _plt()
    p1, y = _cpu(probs1), _cpu(labels)
    curve = reliability_curve(p1, y, n_bins=n_bins)
    conf = curve["confidence"].numpy()
    acc = curve["accuracy"].numpy()
    cnt = curve["count"].numpy()
    ece = float(expected_calibration_error(p1, y, n_bins=n_bins))
    mask = cnt > 0
    fig, (ax, ax2) = plt.subplots(
        2, 1, figsize=(5, 6), height_ratios=[3, 1], sharex=True)
    ax.plot([0, 1], [0, 1], "--", color="gray", label="perfect")
    ax.plot(conf[mask], acc[mask], marker="o",
            label=f"model (ECE = {ece:.3f})")
    ax.set_ylabel("empirical accuracy")
    ax.legend()
    edges = np.linspace(0, 1, n_bins + 1)
    ax2.bar((edges[:-1] + edges[1:]) / 2, cnt, width=0.9 / n_bins)
    ax2.set_xlabel("predicted probability")
    ax2.set_ylabel("count")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_threshold_sweep(probs1: np.ndarray, labels: np.ndarray,
                         path: str | Path = "threshold_sweep.png"):
    """F1 / sensitivity / specificity across decision thresholds, with the
    best-F1 operating point marked (report/calibration.threshold_sweep)."""
    from multimodal_eeg_fmri_tpu_torch.report.calibration import (
        threshold_sweep,
    )

    plt = _plt()
    ts = np.linspace(0, 1, 101).astype(np.float32)
    sw = {k: v.numpy() for k, v in threshold_sweep(
        _cpu(probs1), _cpu(labels), _cpu(ts)).items()}
    fig, ax = plt.subplots(figsize=(6, 4))
    for name in ("f1", "sensitivity", "specificity"):
        ax.plot(ts, np.asarray(sw[name]), label=name)
    best = int(np.argmax(np.asarray(sw["f1"])))
    ax.axvline(ts[best], color="gray", linestyle="--",
               label=f"best F1 @ {ts[best]:.2f}")
    ax.set_xlabel("threshold")
    ax.set_ylabel("metric")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_confusion(preds: np.ndarray, labels: np.ndarray,
                   path: str | Path = "confusion.png"):
    from sklearn.metrics import confusion_matrix

    plt = _plt()
    cm = confusion_matrix(labels, preds)
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(cm, cmap="Blues")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_tsne_embeddings(features: np.ndarray, labels: np.ndarray,
                         path: str | Path = "tsne.png",
                         perplexity: float = 10.0, seed: int = 0):
    from sklearn.manifold import TSNE

    plt = _plt()
    perplexity = min(perplexity, max(2, len(features) // 2 - 1))
    emb = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed).fit_transform(np.asarray(features))
    fig, ax = plt.subplots(figsize=(5, 5))
    for cls in np.unique(labels):
        m = labels == cls
        ax.scatter(emb[m, 0], emb[m, 1], label=f"class {cls}", alpha=0.7)
    ax.legend()
    ax.set_title("t-SNE of fused features")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_channel_importance(ci, path: str | Path = "channel_importance.png",
                            top_k: int = 15):
    plt = _plt()
    top = ci.top_k(top_k)
    names = [t[0] for t in top][::-1]
    vals = [t[1] for t in top][::-1]
    fig, ax = plt.subplots(figsize=(6, 0.35 * len(top) + 1.5))
    ax.barh(names, vals)
    ax.set_xlabel("importance")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_topomap(ci, path: str | Path = "topomap.png"):
    """Interpolated scalp map of channel importance over 10-20 positions."""
    from multimodal_eeg_fmri_tpu_torch.xai.montage import CHANNEL_POSITIONS

    plt = _plt()
    from scipy.interpolate import griddata

    pts, vals = [], []
    for name, v in ci.values.items():
        if name in CHANNEL_POSITIONS:
            pts.append(CHANNEL_POSITIONS[name])
            vals.append(v)
    pts = np.asarray(pts)
    vals = np.asarray(vals)
    gx, gy = np.meshgrid(np.linspace(0, 1, 100), np.linspace(0, 1, 100))
    gz = griddata(pts, vals, (gx, gy), method="cubic")
    fig, ax = plt.subplots(figsize=(5, 5))
    # mask to head circle
    mask = (gx - 0.5) ** 2 + (gy - 0.5) ** 2 > 0.25
    gz = np.where(mask, np.nan, gz)
    im = ax.imshow(gz, origin="lower", extent=(0, 1, 0, 1), cmap="RdBu_r")
    ax.scatter(pts[:, 0], pts[:, 1], c="k", s=8)
    for (x, y), name in zip(pts, [n for n in ci.values
                                  if n in CHANNEL_POSITIONS]):
        ax.annotate(name, (x, y), fontsize=6, ha="center", va="bottom")
    circ = plt.Circle((0.5, 0.5), 0.5, fill=False, color="k")
    ax.add_patch(circ)
    ax.axis("off")
    fig.colorbar(im, shrink=0.7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_region_radar(ci, path: str | Path = "region_radar.png"):
    """Radar chart of region importance (reference
    ``plot_region_comparison``, ``eeg_xai_analysis.py:803-833``)."""
    plt = _plt()
    regions = list(ci.region_values)
    vals = [ci.region_values[r] for r in regions]
    angles = np.linspace(0, 2 * np.pi, len(regions), endpoint=False).tolist()
    vals_c = vals + vals[:1]
    angles_c = angles + angles[:1]
    fig, ax = plt.subplots(figsize=(5, 5),
                           subplot_kw={"projection": "polar"})
    ax.plot(angles_c, vals_c, "o-")
    ax.fill(angles_c, vals_c, alpha=0.25)
    ax.set_xticks(angles)
    ax.set_xticklabels(regions)
    ax.set_title("Region importance")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)


def plot_connectivity_matrix(matrix: np.ndarray,
                             channel_names: Sequence[str],
                             path: str | Path = "connectivity.png"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, cmap="viridis")
    ax.set_xticks(range(len(channel_names)))
    ax.set_yticks(range(len(channel_names)))
    ax.set_xticklabels(channel_names, rotation=90, fontsize=6)
    ax.set_yticklabels(channel_names, fontsize=6)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return Path(path)
