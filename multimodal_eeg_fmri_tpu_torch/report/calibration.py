"""Probability calibration and decision-threshold analysis (PyTorch).
Counterpart of ``multimodal_eeg_fmri_tpu/report/calibration.py``.

Every function takes tensors or arrays, reduces in f32 on the inputs'
device (a tensor's own; the card for an array, as the JAX package's
``jnp.asarray`` puts one on its default device), takes an optional
sample-weight mask (padded fold rows drop out) and returns tensors, without
reading a value back to the host.

- ``reliability_curve`` / ``expected_calibration_error``: equal-width
  confidence bins via one scatter-add (no loop over bins).
- ``brier_score``: weighted squared error of the positive-class
  probability.
- ``fit_temperature`` / ``fit_temperature_ensemble``: temperature scaling
  (Guo et al. 2017) by a bounded golden-section search on log T, a fixed
  number of steps of tensor ops (the JAX package's ``lax.scan``).
- ``threshold_sweep`` / ``optimal_threshold``: vectorized metric sweep
  over candidate thresholds, maximizing F1 or Youden's J.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device


def _t(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; by default a tensor stays on its
    own device and an array goes to the card (raising if there is none)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else model_device("cuda")
    return torch.as_tensor(x, dtype=dtype, device=device)


def _w(weights, n: int, device) -> torch.Tensor:
    if weights is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return _t(weights, device=device).float()


def reliability_curve(
    probs,                         # (N,) positive-class probability
    labels,                        # (N,) {0,1}
    n_bins: int = 10,
    weights=None,
) -> Dict[str, torch.Tensor]:
    """Equal-width reliability diagram data.

    Returns ``{"confidence", "accuracy", "count"}``, each (n_bins,);
    empty bins report 0 count and NaN confidence/accuracy (sklearn's
    ``calibration_curve`` drops them — comparison masks on count > 0).
    """
    probs = _t(probs).float()
    labels = _t(labels, device=probs.device)
    w = _w(weights, probs.shape[0], probs.device)
    # truncation like np.digitize(right=False) - 1, clipped so p == 1.0
    # lands in the last bin
    idx = (probs * n_bins).to(torch.int32).clamp(0, n_bins - 1).long()

    def segment_sum(x):
        return torch.zeros(n_bins, dtype=torch.float32,
                           device=probs.device).index_add_(0, idx, x)

    wsum = segment_sum(w)
    conf = segment_sum(w * probs)
    acc = segment_sum(w * (labels == 1))
    safe = torch.where(wsum > 0, wsum, 1.0)
    nan = torch.tensor(float("nan"), device=probs.device)
    return {
        "confidence": torch.where(wsum > 0, conf / safe, nan),
        "accuracy": torch.where(wsum > 0, acc / safe, nan),
        "count": wsum,
    }


def expected_calibration_error(probs, labels, n_bins: int = 10,
                               weights=None) -> torch.Tensor:
    """ECE = Σ_b (n_b/N) · |acc_b − conf_b| over equal-width bins."""
    curve = reliability_curve(probs, labels, n_bins, weights)
    n = curve["count"].sum().clamp_min(1e-8)
    gap = (curve["accuracy"] - curve["confidence"]).abs()
    return torch.nansum(curve["count"] / n * torch.nan_to_num(gap))


def brier_score(probs, labels, weights=None) -> torch.Tensor:
    probs = _t(probs).float()
    labels = _t(labels, device=probs.device)
    w = _w(weights, probs.shape[0], probs.device)
    sq = (probs - (labels == 1).float()) ** 2
    return (w * sq).sum() / w.sum().clamp_min(1e-8)


def fit_temperature(
    logits,                        # (N, C)
    labels,                        # (N,)
    weights=None,
    n_steps: int = 48,
    log_t_bound: float = 4.0,
) -> torch.Tensor:
    """Temperature T > 0 minimizing weighted NLL of ``softmax(logits/T)``.

    Golden-section search on u = log T over [−bound, bound]
    (T ∈ [0.018, 54.6] at the default): the NLL is quasi-convex in u but
    NOT convex — on a perfectly-separated eval set it decreases
    monotonically toward u → −∞, where an unguarded Newton walks to the
    wrong stationary point. A bounded, derivative-free bracket is robust to
    both that degeneracy and f32 saturation (48 steps shrink the bracket
    below 1e-8). Apply with ``logits / T``.
    """
    logits = _t(logits).float()
    labels = _t(labels, device=logits.device).long()
    w = _w(weights, logits.shape[0], logits.device)
    wsum = w.sum().clamp_min(1e-8)

    def nll(u):
        logp = F.log_softmax(logits * torch.exp(-u), dim=-1)
        picked = logp.gather(-1, labels[:, None])[:, 0]
        return -(w * picked).sum() / wsum

    return torch.exp(_golden_min(nll, log_t_bound, n_steps, logits.device))


def fit_temperature_ensemble(
    member_logits,                 # (K, N, C) one row of logits per member
    labels,                        # (N,)
    weights=None,
    n_steps: int = 48,
    log_t_bound: float = 4.0,
) -> torch.Tensor:
    """Shared temperature for a late-fusion ensemble.

    The ensemble probability is the MEAN of member softmaxes (the
    reference's late fusion, `CrossModal_EEG_scr.ipynb §34`), so the
    temperature must sit inside each member's softmax —
    ``mean_k softmax(z_k / T)`` — and the NLL is not the plain softmax NLL
    ``fit_temperature`` minimizes. Same bounded golden-section scaffold.
    """
    member_logits = _t(member_logits).float()
    labels = _t(labels, device=member_logits.device).long()
    w = _w(weights, member_logits.shape[1], member_logits.device)
    wsum = w.sum().clamp_min(1e-8)

    def nll(u):
        p = torch.softmax(member_logits * torch.exp(-u), dim=-1)
        mean_p = p.mean(dim=0)                            # (N, C)
        picked = mean_p.gather(-1, labels[:, None])[:, 0]
        return -(w * torch.log(picked + 1e-9)).sum() / wsum

    return torch.exp(_golden_min(nll, log_t_bound, n_steps,
                                 member_logits.device))


def _golden_min(f: Callable, bound: float, n_steps: int,
                device) -> torch.Tensor:
    """Golden-section minimum of scalar ``f`` over [−bound, bound] in f32,
    a fixed number of steps on 0-d tensors (no value read back).

    Classic single-evaluation form: each step keeps one interior point and
    its value, so only the NEW point's ``f`` is computed."""
    phi = 0.6180339887498949  # 1/golden ratio
    lo = torch.tensor(-bound, dtype=torch.float32, device=device)
    hi = torch.tensor(bound, dtype=torch.float32, device=device)
    m1 = hi - phi * (hi - lo)
    m2 = lo + phi * (hi - lo)
    f1, f2 = f(m1), f(m2)
    for _ in range(n_steps):
        shrink_hi = f1 < f2  # keep [lo, m2]; m1 survives as the new m2
        lo, hi = (torch.where(shrink_hi, lo, m1),
                  torch.where(shrink_hi, m2, hi))
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        f_new = f(torch.where(shrink_hi, m1, m2))
        f1, f2 = (torch.where(shrink_hi, f_new, f2),
                  torch.where(shrink_hi, f1, f_new))
    return (lo + hi) / 2.0


def threshold_sweep(probs, labels, thresholds,
                    weights=None) -> Dict[str, torch.Tensor]:
    """Weighted confusion metrics at every threshold (vectorized).

    Returns ``{"f1", "youden", "sensitivity", "specificity"}``, each of
    shape ``thresholds.shape``. Prediction rule: positive iff
    ``p >= threshold`` (ties at the threshold count positive, matching
    ``(probs >= 0.5)`` argmax for symmetric binary logits).
    """
    probs = _t(probs).float()
    labels = _t(labels, device=probs.device)
    thresholds = _t(thresholds, device=probs.device).float()
    w = _w(weights, probs.shape[0], probs.device)
    pos = (labels == 1).float() * w
    neg = (labels == 0).float() * w
    pred = (probs[None, :] >= thresholds[:, None]).float()
    tp = pred @ pos
    fp = pred @ neg
    fn = pos.sum() - tp
    tn = neg.sum() - fp
    sens = tp / (tp + fn).clamp_min(1e-8)
    spec = tn / (tn + fp).clamp_min(1e-8)
    f1 = 2 * tp / (2 * tp + fp + fn).clamp_min(1e-8)
    return {"f1": f1, "youden": sens + spec - 1.0,
            "sensitivity": sens, "specificity": spec}


def optimal_threshold(
    probs,
    labels,
    metric: str = "f1",            # or "youden"
    n_grid: int = 101,
    weights=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(threshold, value) maximizing ``metric`` on an even [0, 1] grid
    (the first grid point where several tie). At n_grid=101 the resolution
    (0.01) is finer than any fold of the reference's 66-subject data can
    resolve."""
    probs = _t(probs)
    ts = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float32,
                        device=probs.device)
    vals = threshold_sweep(probs, labels, ts, weights)[metric]
    i = torch.argmax(vals)
    return ts[i], vals[i]
