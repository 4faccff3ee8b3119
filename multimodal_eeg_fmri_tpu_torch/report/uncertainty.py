"""Ensemble uncertainty: predictive, aleatoric and epistemic parts.
Counterpart of ``multimodal_eeg_fmri_tpu/report/uncertainty.py``.

Given the members' probabilities (``EnsemblePredictor(reduce="none")``):

- predictive entropy  H[mean_k p_k]        the total uncertainty;
- expected entropy    mean_k H[p_k]        the aleatoric part;
- mutual information  BALD = predictive − expected, the epistemic part
  (Houlsby et al. 2011; ≥ 0 by Jensen, 0 when all members agree);
- ``disagreement``: the fraction of members whose argmax differs from the
  ensemble's vote.

Natural-log entropies, per example, in f32 on the input's device.
"""

from __future__ import annotations

from typing import Dict

import torch


def _entropy(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    p = p.float()
    return -(p * torch.log(p.clamp(1e-12, 1.0))).sum(dim=dim)


def ensemble_uncertainty(member_probs) -> Dict[str, torch.Tensor]:
    """Decompose the uncertainty of (K, n, C) member probabilities (a
    tensor, or an array that goes to the CPU). Returns (n,) tensors:
    ``predictive_entropy``, ``expected_entropy``, ``mutual_information``
    (BALD, clipped at 0 against round-off) and ``disagreement``."""
    member_probs = torch.as_tensor(member_probs).float()
    mean_p = member_probs.mean(dim=0)                       # (n, C)
    predictive = _entropy(mean_p)
    expected = _entropy(member_probs).mean(dim=0)
    bald = (predictive - expected).clamp_min(0.0)
    vote = mean_p.argmax(dim=-1)                            # (n,)
    member_votes = member_probs.argmax(dim=-1)              # (K, n)
    disagreement = (member_votes != vote[None, :]).float().mean(dim=0)
    return {
        "predictive_entropy": predictive,
        "expected_entropy": expected,
        "mutual_information": bald,
        "disagreement": disagreement,
    }
