"""Input-drift monitoring for a served predictor (CUSUM and EWMA).
Counterpart of ``multimodal_eeg_fmri_tpu/report/drift.py``, with the same
``(init, step)`` contract: a state is a ``NamedTuple`` of tensors and a
``step`` takes the state and one sample and returns the new state.

- ``ewma_step``: exponentially weighted running mean and variance.
- ``cusum_step``: two-sided standardized CUSUM (Page 1954): S⁺ and S⁻
  accumulate standardized deviations beyond a slack ``k``, and an alarm
  fires when either exceeds ``h``. ``k = δ/2`` is the classic tuning for a
  δ·σ mean shift.
- ``make_drift_monitor``: a per-feature two-sided CUSUM against frozen
  reference statistics (from the training data), alarming when any
  feature drifts, with an EWMA for reporting.

Every state lives on the device of the reference statistics, so a monitor
of a served model's inputs runs where the model does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class EWMAState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    initialized: torch.Tensor   # bool scalar: the first sample seeds the mean


def ewma_init(shape, device=None) -> EWMAState:
    return EWMAState(mean=torch.zeros(shape, device=device),
                     var=torch.zeros(shape, device=device),
                     initialized=torch.tensor(False, device=device))


def ewma_step(state: EWMAState, x: torch.Tensor,
              alpha: float = 0.05) -> EWMAState:
    """One EWMA update (West 1979's incremental variance)."""
    x = torch.as_tensor(x, device=state.mean.device).float()
    mean0 = torch.where(state.initialized, state.mean, x)
    delta = x - mean0
    mean = mean0 + alpha * delta
    var = torch.where(state.initialized,
                      (1 - alpha) * (state.var + alpha * delta * delta),
                      state.var)
    return EWMAState(mean=mean, var=var,
                     initialized=torch.ones_like(state.initialized))


class CUSUMState(NamedTuple):
    s_pos: torch.Tensor
    s_neg: torch.Tensor
    alarms: torch.Tensor        # int32 cumulative alarm count (same shape)


def cusum_init(shape, device=None) -> CUSUMState:
    z = torch.zeros(shape, device=device)
    return CUSUMState(s_pos=z, s_neg=z.clone(),
                      alarms=torch.zeros(shape, dtype=torch.int32,
                                         device=device))


def cusum_step(state: CUSUMState, z: torch.Tensor, k: float = 0.5,
               h: float = 5.0, reset: bool = True
               ) -> Tuple[CUSUMState, torch.Tensor]:
    """Two-sided CUSUM update of standardized observation(s) ``z``;
    returns (state, alarm now as a bool tensor). ``reset`` restarts the
    statistic after an alarm."""
    z = torch.as_tensor(z, device=state.s_pos.device).float()
    s_pos = (state.s_pos + z - k).clamp_min(0.0)
    s_neg = (state.s_neg - z - k).clamp_min(0.0)
    alarm = (s_pos > h) | (s_neg > h)
    if reset:
        s_pos = torch.where(alarm, 0.0, s_pos)
        s_neg = torch.where(alarm, 0.0, s_neg)
    return CUSUMState(s_pos=s_pos, s_neg=s_neg,
                      alarms=state.alarms + alarm.int()), alarm


class DriftState(NamedTuple):
    cusum: CUSUMState
    ewma: EWMAState
    n: torch.Tensor             # int32 samples seen


def make_drift_monitor(ref_mean, ref_std, k: float = 0.5, h: float = 8.0,
                       alpha: float = 0.05, device=None):
    """``(init, step)`` watching (F,) feature vectors against the reference
    statistics ``ref_mean`` and ``ref_std`` (F,), on ``device`` (by default
    that of ``ref_mean`` if it is a tensor, else the CPU).

    ``step(state, x) -> (state, out)`` with ``out = {"alarm"`` (bool
    scalar: some feature drifted on this sample), ``"per_feature"`` ((F,)
    bool), ``"ewma_mean"`` ((F,))}. Standardization uses the frozen
    reference statistics, so the monitor does not adapt to the drift it is
    looking for; the EWMA only reports."""
    if device is None and torch.is_tensor(ref_mean):
        device = ref_mean.device
    mu = torch.as_tensor(ref_mean, device=device).float()
    sd = torch.as_tensor(ref_std, device=mu.device).float().clamp_min(1e-8)
    shape = mu.shape

    def init() -> DriftState:
        return DriftState(cusum=cusum_init(shape, mu.device),
                          ewma=ewma_init(shape, mu.device),
                          n=torch.tensor(0, dtype=torch.int32,
                                         device=mu.device))

    def step(state: DriftState, x):
        x = torch.as_tensor(x, device=mu.device).float()
        cusum, alarm = cusum_step(state.cusum, (x - mu) / sd, k=k, h=h)
        ewma = ewma_step(state.ewma, x, alpha=alpha)
        out = {"alarm": alarm.any(), "per_feature": alarm,
               "ewma_mean": ewma.mean}
        return DriftState(cusum=cusum, ewma=ewma, n=state.n + 1), out

    return init, step
