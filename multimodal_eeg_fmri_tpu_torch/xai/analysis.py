"""Channel/region importance extraction + attention/fusion-weight analysis
(PyTorch). Counterpart of ``multimodal_eeg_fmri_tpu/xai/analysis.py``: the
numpy functions are copied; the weight extraction is one eval-mode forward
on the model's device.

Reference equivalents: ``ChannelImportanceExtractor``
(``eeg_xai_analysis.py:372-491`` — per-channel mean |attribution|,
normalization, region grouping, top-k), ``EEGExplainer.analyze_dataset``
(``:617-672``), and ``extract_attention_and_fusion_weights``
(``bridge_utils.py:236-268`` — per-subject attention + dynamic fusion
weights with class-wise comparison, ``_test_bridge.py:1250-1311``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_eeg_fmri_tpu_torch.train.evaluate import apply_model
from multimodal_eeg_fmri_tpu_torch.xai.montage import (
    REGION_GROUPS,
    default_channel_names,
    pair_names,
)


@dataclass
class ChannelImportance:
    """Normalized per-channel importance with montage metadata."""

    values: Dict[str, float]
    region_values: Dict[str, float]
    channel_names: List[str]

    def top_k(self, k: int = 5) -> List[Tuple[str, float]]:
        return sorted(self.values.items(), key=lambda kv: -kv[1])[:k]

    def as_array(self) -> np.ndarray:
        return np.asarray([self.values[c] for c in self.channel_names])


def channel_importance_from_attribution(
    attribution: np.ndarray,  # (B, T, C) or (B, C) or (T, C)
    channel_names: Optional[Sequence[str]] = None,
    channel_axis: int = -1,
    normalize: bool = True,
) -> ChannelImportance:
    """Mean |attribution| per channel over batch/time, optionally normalized
    to sum 1, grouped into scalp regions."""
    a = np.abs(np.asarray(attribution))
    a = np.moveaxis(a, channel_axis, -1)
    imp = a.reshape(-1, a.shape[-1]).mean(axis=0)
    if normalize and imp.sum() > 0:
        imp = imp / imp.sum()
    names = list(channel_names) if channel_names else default_channel_names(
        imp.shape[0])
    values = {n: float(v) for n, v in zip(names, imp)}
    regions = {}
    for region, chans in REGION_GROUPS.items():
        vals = [values[c] for c in chans if c in values]
        regions[region] = float(np.mean(vals)) if vals else 0.0
    return ChannelImportance(values, regions, names)


def connectivity_pair_importance(
    attribution: np.ndarray,  # (B, F) over the 3×C(n,2) CONN features
    channel_names: Optional[Sequence[str]] = None,
    n_metrics: int = 3,
) -> Dict[Tuple[str, str], float]:
    """Map flattened CONN attributions back to channel pairs, averaging over
    metrics (reference ``get_pair_importance``)."""
    a = np.abs(np.asarray(attribution))
    if a.ndim == 1:
        a = a[None]
    mean = a.mean(axis=0)
    n_pairs = mean.shape[0] // n_metrics
    per_pair = mean.reshape(n_metrics, n_pairs).mean(axis=0)
    # infer channel count from C(n,2) = n_pairs
    n = int((1 + np.sqrt(1 + 8 * n_pairs)) / 2)
    names = list(channel_names) if channel_names else default_channel_names(n)
    return {p: float(v) for p, v in zip(pair_names(names), per_pair)}


def extract_attention_and_fusion_weights(
    model, params, batch_stats, data: Dict[str, np.ndarray]
) -> List[dict]:
    """Per-subject prediction + fusion weights + attention weights, one
    batched eval-mode forward on the model's device
    (``train/evaluate.apply_model``; the reference loops subjects one at a
    time). ``params``/``batch_stats`` None take the module's own."""
    out = apply_model(model, params, batch_stats, data)

    def host(t):
        return None if t is None else t.float().cpu().numpy()

    n = len(np.asarray(data["label"]))
    preds = np.argmax(host(out.logits), axis=-1)
    fusion_w = (host(out.fusion_weights)
                if out.fusion_weights is not None else [None] * n)
    attn_w = (host(out.attn_weights)
              if out.attn_weights is not None else [None] * n)
    subjects = np.asarray(data.get("subject", np.arange(n)))
    labels = np.asarray(data["label"])
    return [
        {
            "subject": int(subjects[i]),
            "label": int(labels[i]),
            "prediction": int(preds[i]),
            "fusion_weights": (np.squeeze(fusion_w[i])
                               if fusion_w[i] is not None else None),
            "attn_weights": (np.squeeze(attn_w[i])
                             if attn_w[i] is not None else None),
        }
        for i in range(n)
    ]


def classwise_weight_comparison(records: List[dict]) -> Dict[str, np.ndarray]:
    """Mean fusion weights per true class (reference class-wise analysis,
    ``_test_bridge.py:1250-1311``)."""
    out = {}
    for cls in sorted({r["label"] for r in records}):
        ws = [r["fusion_weights"] for r in records
              if r["label"] == cls and r["fusion_weights"] is not None]
        if ws:
            out[f"class_{cls}"] = np.mean(np.stack(ws), axis=0)
    return out
