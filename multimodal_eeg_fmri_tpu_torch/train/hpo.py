"""Hyperparameter optimization (PyTorch port). Counterpart of
``multimodal_eeg_fmri_tpu/train/hpo.py``.

Reference: ``OptunaHPOTrainer`` (``enhanced_models_v4.py:664-817``) — Optuna
TPE + MedianPruner over 7 hyperparameters (lr, hidden_dim, dropout, layers,
heads, weight_decay, use_gnn), 10-epoch proxy training per trial.

As the JAX package's:
- Search: quasi-random low-discrepancy sampling (scrambled Halton) over the
  space; ``sample_trials`` is the same numpy code and gives the same trials.
- Pruning: successive halving between rungs replaces the MedianPruner
  (proxy-epochs rung → top fraction → full-epoch rung).
- Trials are grouped by architecture (every hyperparameter but lr and wd).
  The JAX package trains a group's trials under one ``vmap``; the port
  trains them one after another on the model's device, each from fresh
  weights, with ``hyper={"lr", "wd"}`` through ``make_fit_fn``. The trial at
  position ``j`` of its group takes the streams of ``fold_in(seed, j)``
  (``train/cv.py``'s ``fold_rngs``), as the JAX package seeds it with
  ``fold_in(key(seed), j)``.
- With a ``mesh_plan`` each architecture group's trials are padded to a
  multiple of the ensemble axis with copies of its last trial, and each
  rank trains its contiguous block of them, SPMD (every rank calls with the
  same arguments, as ``train/cv.py``'s ``run_cv`` shards folds); the
  scores are gathered over the ensemble axis once a rung, so every rank
  picks the same finalists and returns the same ``HPOResult``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.core.rng import fold_in
from multimodal_eeg_fmri_tpu_torch.parallel.input import gather_ensemble_tree
from multimodal_eeg_fmri_tpu_torch.train.cv import (
    FoldRng,
    _block,
    _round_up,
    fold_rngs,
    start_fold,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import make_fit_fn


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LogUniform:
    lo: float
    hi: float


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float


@dataclass(frozen=True)
class Choice:
    options: Tuple[Any, ...]


SearchSpace = Dict[str, Any]  # name -> LogUniform | Uniform | Choice

# the reference study's 7-hyperparameter space
# (enhanced_models_v4.py:700-720 equivalents, incl. the model-family axis)
DEFAULT_SPACE: SearchSpace = {
    "lr": LogUniform(1e-5, 1e-2),
    "wd": LogUniform(1e-6, 1e-2),
    "hidden_dim": Choice((64, 96, 128)),
    "dropout": Choice((0.2, 0.3, 0.4, 0.5)),
    "num_transformer_layers": Choice((1, 2, 3)),
    "num_heads": Choice((2, 4, 8)),
    "use_gnn": Choice((False, True)),
}


def build_trimodal(use_gnn: bool = False, *, device="cuda",
                   erp_channels: int = 18, pw_channels: int = 75,
                   conn_shape: Sequence[int] = (18, 18, 3), **arch_kwargs):
    """Model-family factory for the DEFAULT_SPACE ``use_gnn`` axis
    (reference: ``EnhancedTriModalFusionNet(use_gnn=...)``,
    ``enhanced_models_v4.py:700-720``), on ``device``. The GNN family needs
    ``conn`` in matrix form (B, N, N, M); the MLP family flattens it, so one
    matrix-form dataset serves both families in a single study. The port's
    models take their input widths at construction: ``conn_shape`` is a
    row's conn shape, (N, N, M) or (F,) (MLP family only); bind the widths
    with ``functools.partial`` when they differ from the defaults."""
    from multimodal_eeg_fmri_tpu_torch.models import (
        TriModalFusionNetGNN,
        TriModalFusionNetV4,
    )

    widths = dict(erp_channels=erp_channels, pw_channels=pw_channels)
    if use_gnn:
        return TriModalFusionNetGNN(n_nodes=conn_shape[0],
                                    n_metrics=conn_shape[-1], device=device,
                                    **widths, **arch_kwargs)
    return TriModalFusionNetV4(conn_features=int(np.prod(conn_shape)),
                               device=device, **widths, **arch_kwargs)


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def sample_trials(space: SearchSpace, n_trials: int,
                  seed: int = 0) -> List[Dict[str, Any]]:
    """Scrambled-Halton quasi-random samples over the space."""
    rng = np.random.default_rng(seed)
    shifts = {k: rng.random() for k in space}
    trials = []
    for t in range(1, n_trials + 1):
        trial = {}
        for d, (name, spec) in enumerate(space.items()):
            u = (_halton(t, _PRIMES[d % len(_PRIMES)]) + shifts[name]) % 1.0
            if isinstance(spec, LogUniform):
                trial[name] = float(math.exp(
                    math.log(spec.lo)
                    + u * (math.log(spec.hi) - math.log(spec.lo))))
            elif isinstance(spec, Uniform):
                trial[name] = float(spec.lo + u * (spec.hi - spec.lo))
            elif isinstance(spec, Choice):
                trial[name] = spec.options[int(u * len(spec.options))
                                           % len(spec.options)]
            else:
                raise TypeError(f"unknown spec for {name}: {spec!r}")
        trials.append(trial)
    return trials


# ---------------------------------------------------------------------------
# Study
# ---------------------------------------------------------------------------

@dataclass
class HPOResult:
    best_params: Dict[str, Any]
    best_score: float
    trials: List[Dict[str, Any]]          # trial dicts with 'score' added
    rung_scores: List[np.ndarray] = field(default_factory=list)


OPT_KEYS = ("lr", "wd")  # runtime hyperparameters; the rest = architecture


def _start_trial(model, arch_kwargs: Dict[str, Any], j: int,
                 seed: int) -> FoldRng:
    """Fresh weights for the trial at position ``j`` of the architecture
    group ``arch_kwargs``, from the streams of ``fold_in(seed, j)``; returns
    the streams."""
    rngs = fold_rngs(fold_in(seed, j), next(model.parameters()).device)
    start_fold(model, rngs)
    return rngs


def run_hpo(
    model_builder: Callable[..., Any],  # (**arch_kwargs) -> nn.Module
    base_cfg: TrainConfig,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    space: Optional[SearchSpace] = None,
    n_trials: int = 16,
    proxy_epochs: int = 10,
    full_epochs: Optional[int] = None,
    top_fraction: float = 0.25,
    seed: int = 0,
    class_weights: Optional[np.ndarray] = None,
    metric: str = "f1",
    mesh_plan=None,
) -> HPOResult:
    """Quasi-random search + successive halving.

    Rung 1: all trials at ``proxy_epochs`` (the reference's 10-epoch proxy),
    one after another within architecture groups. Rung 2: top
    ``top_fraction`` rerun at ``full_epochs``. Maximizes val ``metric``.
    Each trial trains the model that ``model_builder`` returns, on its
    device. ``mesh_plan`` shards each group's trials over the ensemble axis
    (the module's docstring)."""
    space = space or DEFAULT_SPACE
    trials = sample_trials(space, n_trials, seed)
    m = mesh_plan.n_ensemble if mesh_plan is not None else 1

    def arch_key(trial):
        return tuple(sorted(
            (k, v) for k, v in trial.items()
            if k not in OPT_KEYS and k != "score"))

    def run_rung(rung_trials: List[dict], epochs: int) -> np.ndarray:
        by_arch: Dict[tuple, List[int]] = {}
        for i, t in enumerate(rung_trials):
            by_arch.setdefault(arch_key(t), []).append(i)
        # this rank's scores, group after group: its block of each group's
        # padded trials
        local = []
        for key, idxs in by_arch.items():
            arch_kwargs = dict(key)
            model = model_builder(**arch_kwargs)
            cfg = dataclasses.replace(base_cfg, num_epochs=epochs,
                                      selection="val")
            fit_fn = make_fit_fn(model, cfg, eval_names=("val",))
            pad_idx = idxs + [idxs[-1]] * (_round_up(len(idxs), m)
                                           - len(idxs))
            for j in _block(mesh_plan, len(pad_idx)):
                trial = rung_trials[pad_idx[j]]
                rngs = _start_trial(model, arch_kwargs, j, seed)
                res = fit_fn(rngs.shuffle, train_data, {"val": val_data},
                             class_weights,
                             {"lr": trial["lr"],
                              "wd": trial.get("wd", cfg.weight_decay)})
                # best val metric over epochs (MedianPruner analogue: the
                # proxy score IS the selection metric at its best epoch)
                local.append(res.history[f"val_{metric}"].max().cpu())
        # every group's scores on every rank: one gather a rung
        got = gather_ensemble_tree(mesh_plan,
                                   torch.stack(local)[None]).numpy()
        scores = np.full(len(rung_trials), -np.inf)
        at = 0
        for idxs in by_arch.values():
            per = _round_up(len(idxs), m) // m
            block = got[:, at:at + per].reshape(-1)
            for j, i in enumerate(idxs):
                scores[i] = float(block[j])
            at += per
        return scores

    scores1 = run_rung(trials, proxy_epochs)
    for t, s in zip(trials, scores1):
        t["score"] = float(s)
    k = max(1, int(round(n_trials * top_fraction)))
    top_idx = np.argsort(-scores1)[:k]
    finalists = [dict(trials[i]) for i in top_idx]

    full_epochs = full_epochs or base_cfg.num_epochs
    scores2 = run_rung(finalists, full_epochs)
    for t, s in zip(finalists, scores2):
        t["score"] = float(s)
    best_i = int(np.argmax(scores2))
    return HPOResult(
        best_params={k: v for k, v in finalists[best_i].items()
                     if k != "score"},
        best_score=float(scores2[best_i]),
        trials=trials,
        rung_scores=[scores1, scores2],
    )


# ---------------------------------------------------------------------------
# Optional Optuna backend (reference API parity)
# ---------------------------------------------------------------------------

def run_hpo_optuna(
    model_builder: Callable[..., Any],
    base_cfg: TrainConfig,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    space: Optional[SearchSpace] = None,
    n_trials: int = 50,
    timeout: Optional[int] = 3600,
    proxy_epochs: int = 10,
    seed: int = 0,
    class_weights: Optional[np.ndarray] = None,
    metric: str = "f1",
) -> HPOResult:
    """Optuna TPE + MedianPruner study over the same search space — the
    reference's ``OptunaHPOTrainer`` interface (``enhanced_models_v4.py:664-817``).

    Optional backend: raises ImportError with guidance when optuna is not
    installed (the default quasi-random ``run_hpo`` engine needs nothing).
    Trial ``n`` trains from the streams of ``fold_in(seed, n)``; the
    per-epoch val series feeds ``trial.report`` so the MedianPruner can stop
    bad trials.
    """
    try:
        import optuna
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "optuna is not installed; use train.hpo.run_hpo (the built-in "
            "quasi-random engine) or install optuna for this backend"
        ) from e

    space = space or DEFAULT_SPACE
    cfg = dataclasses.replace(base_cfg, num_epochs=proxy_epochs,
                              selection="val")
    trials_out: List[Dict[str, Any]] = []

    def objective(trial):
        params: Dict[str, Any] = {}
        for name, spec in space.items():
            if isinstance(spec, LogUniform):
                params[name] = trial.suggest_float(name, spec.lo, spec.hi,
                                                   log=True)
            elif isinstance(spec, Uniform):
                params[name] = trial.suggest_float(name, spec.lo, spec.hi)
            elif isinstance(spec, Choice):
                params[name] = trial.suggest_categorical(
                    name, list(spec.options))
        arch = {k: v for k, v in params.items() if k not in OPT_KEYS}
        model = model_builder(**arch)
        fit_fn = make_fit_fn(model, cfg, eval_names=("val",))
        rngs = _start_trial(model, arch, trial.number, seed)
        res = fit_fn(rngs.shuffle, train_data, {"val": val_data},
                     class_weights,
                     {"lr": params.get("lr", cfg.learning_rate),
                      "wd": params.get("wd", cfg.weight_decay)})
        series = res.history[f"val_{metric}"].cpu().numpy()
        for epoch, v in enumerate(series):
            trial.report(float(v), epoch)
            if trial.should_prune():
                raise optuna.TrialPruned()
        score = float(series.max())
        trials_out.append({**params, "score": score})
        return score

    study = optuna.create_study(
        direction="maximize",
        sampler=optuna.samplers.TPESampler(seed=seed),
        pruner=optuna.pruners.MedianPruner(n_startup_trials=5,
                                           n_warmup_steps=5),
    )
    study.optimize(objective, n_trials=n_trials, timeout=timeout,
                   show_progress_bar=False)
    return HPOResult(
        best_params=dict(study.best_params),
        best_score=float(study.best_value),
        trials=trials_out,
    )
