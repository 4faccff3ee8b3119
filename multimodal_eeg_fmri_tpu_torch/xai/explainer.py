"""High-level dataset explainer — the ``EEGExplainer`` API surface (PyTorch).
Counterpart of ``multimodal_eeg_fmri_tpu/xai/explainer.py``.

Reference: ``EEGExplainer`` (``eeg_xai_analysis.py:498-693``) wraps a model
and runs per-sample predict → saliency → gradient×input → IG → channel/
region importance, then ``create_analysis_report`` writes plots + a text
report. The reference loops samples on host; here one call explains the
whole dataset batched on the model's device (each attribution is one
forward and one backward, IG's steps folded into the batch) and produces
the same artifact set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor
from multimodal_eeg_fmri_tpu_torch.report.export import (
    export_xai_arrays,
    write_analysis_report,
)
from multimodal_eeg_fmri_tpu_torch.report.plots import (
    plot_channel_importance,
    plot_region_radar,
    plot_topomap,
)
from multimodal_eeg_fmri_tpu_torch.xai.analysis import (
    ChannelImportance,
    channel_importance_from_attribution,
    connectivity_pair_importance,
)
from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
    gradient_saliency,
    gradient_x_input,
    integrated_gradients,
    make_apply_fn,
)


@dataclass
class ExplanationResult:
    predictions: np.ndarray                  # (N,)
    probs: np.ndarray                        # (N, C)
    saliency: Dict[str, np.ndarray]
    grad_x_input: Dict[str, np.ndarray]
    integrated_gradients: Dict[str, np.ndarray]
    channel_importance: Dict[str, ChannelImportance]
    pair_importance: Optional[dict] = None
    region_importance: Dict[str, Dict[str, float]] = field(
        default_factory=dict)


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in tensors.items()}


class Explainer:
    """Batched whole-dataset explainer for any model of the port, on the
    model's device. ``params``/``batch_stats`` (dicts by state-dict name)
    None take the module's own."""

    def __init__(self, model, params=None, batch_stats=None,
                 temporal_keys: Sequence[str] = ("erp", "pw"),
                 conn_key: Optional[str] = "conn",
                 channel_names: Optional[Sequence[str]] = None,
                 ig_steps: int = 50):
        self.model = model
        self.apply_fn = make_apply_fn(model, params, batch_stats)
        self.temporal_keys = tuple(temporal_keys)
        self.conn_key = conn_key
        self.channel_names = channel_names
        self.ig_steps = ig_steps

    def explain(self, inputs: Dict[str, Any],
                target_class=None) -> ExplanationResult:
        inputs = {k: as_tensor(v, self.apply_fn.device)
                  for k, v in inputs.items()}
        with torch.no_grad():
            logits = self.apply_fn(inputs)
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        preds = probs.argmax(-1)

        sal = _host(gradient_saliency(self.apply_fn, inputs, target_class))
        gxi = _host(gradient_x_input(self.apply_fn, inputs, target_class))
        ig = _host(integrated_gradients(self.apply_fn, inputs, target_class,
                                        n_steps=self.ig_steps))

        ci = {}
        regions = {}
        for k in self.temporal_keys:
            if k in ig:
                ci[k] = channel_importance_from_attribution(
                    ig[k], channel_names=(self.channel_names
                                          if k == "erp" else None))
                regions[k] = ci[k].region_values
        pairs = None
        if self.conn_key and self.conn_key in ig:
            arr = ig[self.conn_key]
            if arr.ndim == 2 and arr.shape[1] % 3 == 0:
                pairs = connectivity_pair_importance(
                    arr, channel_names=self.channel_names)

        return ExplanationResult(
            predictions=preds, probs=probs, saliency=sal, grad_x_input=gxi,
            integrated_gradients=ig, channel_importance=ci,
            pair_importance=pairs, region_importance=regions,
        )

    def analyze_dataset(self, inputs: Dict[str, Any],
                        output_dir: str | Path,
                        metrics: Optional[Dict[str, float]] = None,
                        target_class=None) -> ExplanationResult:
        """Explain + write the reference's artifact set (channel bars,
        topomap, region radar, text report, NPZ arrays). The plots need
        matplotlib (and the topomap scipy)."""
        res = self.explain(inputs, target_class)
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        if "erp" in res.channel_importance:
            ci = res.channel_importance["erp"]
            plot_channel_importance(ci, out / "channel_importance.png")
            plot_topomap(ci, out / "topomap.png")
            plot_region_radar(ci, out / "region_radar.png")
            write_analysis_report(out / "xai_report.txt", ci,
                                  metrics=metrics)
        export_xai_arrays(
            {f"ig_{k}": v for k, v in res.integrated_gradients.items()}
            | {f"saliency_{k}": v for k, v in res.saliency.items()},
            out, prefix="xai_arrays", timestamp=False)
        return res
