"""Two-stage bridge pipeline: train → freeze → extract → bridge LOOCV
(PyTorch). Counterpart of ``multimodal_eeg_fmri_tpu/train/bridge_flow.py``.

Reference call stack (SURVEY §3.3, ``_test_bridge.py``):
1. load frozen stage-1 models from fold checkpoints, ``requires_grad_(False)``;
2. ``extract_eeg_features``: forward every EEG sample of a subject through
   the frozen tri-modal net, take the 128-d fused embedding, mean over the
   subject's samples; same for fMRI (64-d);
3. align embeddings by int-coerced subject id (``BridgeFeatureDataset``);
4. LOOCV: per held-out subject train a fresh bridge net (≤50 epochs, early
   stop on train loss), evaluate the held-out subject, run saliency + IG +
   attention extraction per fold.

Here extraction is one eval-mode forward on the model's device (at T ≥ 512
the temporal self-attention takes the flash kernel) and a float64 segment
mean over the subject ids; the LOOCV folds train one after another through
``run_cv`` (the JAX package vmaps them), and the per-fold XAI runs on each
fold's best params in turn (the JAX package vmaps it over folds).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.report.clinical import (
    pooled_clinical_report,
)
from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    binary_classification_metrics,
)
from multimodal_eeg_fmri_tpu_torch.train.cv import (
    CVResult,
    loocv_splits,
    run_cv,
)
from multimodal_eeg_fmri_tpu_torch.train.evaluate import apply_model
from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
    gradient_saliency,
    integrated_gradients,
    make_apply_fn,
)


def extract_fused_features(
    model,
    params,
    batch_stats,
    data: Dict[str, np.ndarray],
    subject_key: str = "subject",
) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen-encoder feature extraction.

    Runs ONE eval-mode forward over all samples on the model's device
    (``params``/``batch_stats`` None take the module's own) and mean-pools
    the ``fused`` embeddings per subject in float64. Returns
    (unique_subjects (S,), embeddings (S, D) float32).
    """
    subjects = np.asarray(data[subject_key]).astype(np.int64)
    out = apply_model(model, params, batch_stats, data)
    fused = out.fused.float().cpu().numpy()

    uniq, inv = np.unique(subjects, return_inverse=True)
    sums = np.zeros((len(uniq), fused.shape[1]), np.float64)
    np.add.at(sums, inv, fused)
    counts = np.bincount(inv, minlength=len(uniq))[:, None]
    return uniq, (sums / counts).astype(np.float32)


def align_bridge_dataset(
    eeg_subjects: np.ndarray,
    eeg_features: np.ndarray,
    fmri_subjects: np.ndarray,
    fmri_features: np.ndarray,
    labels: Dict[int, int],
) -> Dict[str, np.ndarray]:
    """Int-coerced subject alignment (reference ``BridgeFeatureDataset``,
    ``bridge_utils.py:120-152``: '001' != 1 fix). Raises if nothing aligns."""
    eeg_map = {int(s): f for s, f in zip(eeg_subjects, eeg_features)}
    fmri_map = {int(s): f for s, f in zip(fmri_subjects, fmri_features)}
    label_map = {int(k): v for k, v in labels.items()}
    common = sorted(set(eeg_map) & set(fmri_map) & set(label_map))
    if not common:
        raise ValueError(
            "no subjects aligned across EEG/fMRI/labels — check subject ids"
        )
    return {
        "eeg": np.stack([eeg_map[s] for s in common]).astype(np.float32),
        "fmri": np.stack([fmri_map[s] for s in common]).astype(np.float32),
        "label": np.asarray([label_map[s] for s in common], np.int32),
        "subject": np.asarray(common, np.int32),
    }


@dataclass
class BridgeResult:
    cv: CVResult
    loocv_metrics: Dict[str, float]      # pooled over held-out subjects
    per_subject: list                    # per-subject record dicts
    xai: Dict[str, np.ndarray]           # pooled saliency/IG per modality
    clinical: Dict[str, float] = None    # pooled clinical report (LOO conformal)


def run_bridge_loocv(
    bridge_data: Dict[str, np.ndarray],
    cfg: Optional[TrainConfig] = None,
    bridge_dim: int = 128,
    num_heads: int = 4,
    dropout: float = 0.3,
    with_xai: bool = True,
    ig_steps: int = 50,
    *,
    device="cuda",
    initial_variables: Optional[Sequence[Mapping]] = None,
) -> BridgeResult:
    """LOOCV over subjects with per-fold XAI — the reference's outer hot
    loop (``_test_bridge.py:826-989``) — on ``device`` (the card unless the
    caller asks for another). ``initial_variables`` (one flax variable dict
    per fold) goes to ``run_cv``."""
    if cfg is None:
        # Derive from the shared TrainConfig defaults instead of re-hardcoding
        # the whole tree; only the bridge-specific stage-2 knobs differ
        # (reference ``_test_bridge.py:52-86``: lr 1e-4, wd 1e-4, selection
        # on train loss because LOOCV has no val split).
        cfg = dataclasses.replace(
            TrainConfig(), learning_rate=1e-4, weight_decay=1e-4,
            selection="train_loss",
        )
    model = BridgeFusionNet(
        eeg_dim=bridge_data["eeg"].shape[1],
        fmri_dim=bridge_data["fmri"].shape[1],
        bridge_dim=bridge_dim, num_heads=num_heads, dropout=dropout,
        device=device,
    )
    dev = next(model.parameters()).device
    splits = loocv_splits(bridge_data)
    cv = run_cv(model, cfg, bridge_data, splits, normalize="none",
                initial_variables=initial_variables)

    # pooled LOOCV metrics over all held-out subjects (reference aggregates
    # exactly this way: one prediction per subject)
    probs, labels = [], []
    for f in range(cv.n_folds):
        w = cv.test_weight[f] > 0
        probs.append(cv.test_probs[f][w])
        labels.append(cv.test_labels[f][w])
    probs = np.concatenate(probs)
    labels = np.concatenate(labels)
    logits = np.log(np.maximum(probs, 1e-9))
    pooled = {
        k: float(v) for k, v in binary_classification_metrics(
            torch.as_tensor(logits, device=dev),
            torch.as_tensor(labels, device=dev)).items()
    }

    per_subject, xai = [], {}
    if with_xai:
        # per-fold XAI on the held-out subject, fold after fold, each with
        # its fold's best params
        sal, ig, fw, aw = [], [], [], []
        for f, sp in enumerate(splits):
            params = {k: v[f] for k, v in cv.params.items()}
            stats = {k: v[f] for k, v in cv.batch_stats.items()}
            apply_fn = make_apply_fn(model, params, stats)
            inputs = {k: torch.as_tensor(bridge_data[k][sp.test], device=dev)
                      for k in ("eeg", "fmri")}
            sal.append(gradient_saliency(apply_fn, inputs))
            ig.append(integrated_gradients(apply_fn, inputs, n_steps=ig_steps))
            out = apply_model(model, params, stats, inputs)
            fw.append(out.fusion_weights)
            aw.append(out.attn_weights)

        def host(per_fold):
            return torch.stack(per_fold).cpu().numpy()

        xai = {
            f"{name}_{k}": host([a[k] for a in attr])[:, 0]
            for name, attr in (("saliency", sal), ("ig", ig))
            for k in ("eeg", "fmri")
        }
        fw, aw = host(fw), host(aw)
        for f, sp in enumerate(splits):
            subj = int(bridge_data["subject"][sp.test[0]])
            w = cv.test_weight[f] > 0
            per_subject.append({
                "subject": subj,
                "label": int(bridge_data["label"][sp.test[0]]),
                "prediction": int(np.argmax(cv.test_probs[f][w][0])),
                "prob_class1": float(cv.test_probs[f][w][0][1]),
                "fusion_weights": fw[f, 0],
                "attn_weights": np.squeeze(aw[f, 0]),
            })

    clinical = pooled_clinical_report(probs, labels, device=dev)
    return BridgeResult(cv=cv, loocv_metrics=pooled,
                        per_subject=per_subject, xai=xai,
                        clinical=clinical)
