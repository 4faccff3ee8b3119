"""Cross-validation runs (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/train/cv.py``.

The reference runs its CV protocols as sequential Python loops: 5-fold
SGKF × 4 models (``CrossModal_EEG_scr.ipynb §30``), LOSO over ~60 subjects
(§31), fMRI 5-fold × 3 models (``run_fmri_v11.py:715-931``), bridge LOOCV
over 32 subjects (``_test_bridge.py:826-989``). Every fold trains a fresh
tiny model.

Here each run, as the JAX package's:
1. generates split indices on the host with the same protocols
   (data/splits.py — split identity parity, without sklearn);
2. applies leakage-safe per-fold normalization (data/normalize.py);
3. pads folds to a common fixed shape with weight masks and stacks them on a
   leading fold axis (the same arrays as the JAX package's);
4. trains each fold with ``make_fit_fn`` on the model's device, one fold
   after another (the JAX package vmaps ``fit`` over the fold axis; the
   port's ``fit`` trains a module in place), each from fresh weights;
5. evaluates each fold's best state on its test set in eval mode and
   aggregates mean ± std like the reference's summaries.

Randomness. Fold ``i`` of a run with root seed ``s`` gets the seed
``fold_in(s, i)`` (``core/rng.py``), and from it three streams, as the JAX
package's ``fit`` splits a fold's key in three: the initial weights
(``convert.init_weights`` with a CPU generator, so they do not depend on the
device), the dropout stream (the device's default generator, seeded per
fold; the caller's generator state is restored afterwards) and the shuffle
and augmentation stream (a generator on the model's device). ``rng`` is an
int, a ``torch.Generator`` (its ``initial_seed()``) or one seed or generator
per fold. ``initial_variables`` hands each fold flax variables instead of
fresh weights (what the JAX package's ``fit`` initialises from the fold's
key), which makes a run comparable with the JAX package's number for
number.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.core.rng import (
    as_seed,
    device_generator,
    fold_in,
    generator,
)
from multimodal_eeg_fmri_tpu_torch.data.arrays import (
    balanced_class_weights,
    pad_rows,
    stack_trees,
    subset,
    validate_dataset,
)
from multimodal_eeg_fmri_tpu_torch.data.normalize import (
    FoldNormalizer,
    feature_standardize,
)
from multimodal_eeg_fmri_tpu_torch.data.splits import (
    Split,
    leave_one_out,
    leave_one_subject_out,
    stratified_group_kfold,
    stratified_kfold,
)
from multimodal_eeg_fmri_tpu_torch.report.stats import confidence_interval
from multimodal_eeg_fmri_tpu_torch.train.evaluate import evaluate_dataset
from multimodal_eeg_fmri_tpu_torch.train.fit import FitResult, make_fit_fn

Seed = Union[int, torch.Generator]


@dataclass
class CVResult:
    """Outcome of one model across all folds."""

    fold_metrics: Dict[str, np.ndarray]       # metric -> (n_folds,)
    summary: Dict[str, Tuple[float, float]]   # metric -> (mean, std)
    params: Dict[str, torch.Tensor]           # name -> fold-stacked (F, ...)
    batch_stats: Dict[str, torch.Tensor]      # best buffers, (F, ...)
    history: Dict[str, np.ndarray]            # metric -> (n_folds, epochs)
    best_epochs: np.ndarray                   # (n_folds,)
    n_folds: int
    # per-sample test-set outputs for stats/late-fusion/XAI:
    test_probs: Optional[np.ndarray] = None   # (n_folds, n_test_max, C)
    test_labels: Optional[np.ndarray] = None  # (n_folds, n_test_max)
    test_weight: Optional[np.ndarray] = None  # mask (n_folds, n_test_max)
    test_subjects: Optional[np.ndarray] = None

    def metric(self, name: str) -> Tuple[float, float]:
        return self.summary[name]


def build_fold_arrays(
    data: Dict[str, np.ndarray],
    splits: Sequence[Split],
    normalize: str = "scalar",
    normalize_keys: Sequence[str] = (),
    num_classes: int = 2,
    weighted_classes: bool = True,
):
    """Normalize per fold, pad to fixed shapes, stack on a fold axis.

    Returns (train_stack, eval_stacks{'val','test'}, class_weights (F,C)):
    the JAX package's arrays with its fold axis unpadded (``fold_multiple``
    1), which it pads only to shard folds over a mesh.
    """
    trains, vals, tests, cws = [], [], [], []
    for sp in splits:
        if normalize == "scalar" and normalize_keys:
            d = FoldNormalizer(normalize_keys).fit_transform(data, sp.train)
        elif normalize == "feature" and normalize_keys:
            d = feature_standardize(data, sp.train, normalize_keys)
        else:
            d = data
        trains.append(subset(d, sp.train))
        vals.append(subset(d, sp.val))
        tests.append(subset(d, sp.test))
        if weighted_classes:
            cws.append(balanced_class_weights(
                np.asarray(d["label"])[sp.train], num_classes))
        else:
            cws.append(np.ones((num_classes,), np.float32))

    def _stack(folds: List[dict]):
        target = max(len(next(iter(f.values()))) for f in folds)
        return stack_trees([pad_rows(f, target) for f in folds])

    return (_stack(trains), {"val": _stack(vals), "test": _stack(tests)},
            np.stack(cws))


class FoldRng(NamedTuple):
    """The three streams of one fold (or seed) of a run."""

    init: torch.Generator       # CPU: the initial weights
    dropout_seed: int           # the device's default generator
    shuffle: torch.Generator    # the model's device: shuffles, augmentation


def fold_seeds(rng: Union[Seed, Sequence[Seed]], n: int) -> List[int]:
    """Per-fold seeds: ``fold_in(seed, i)`` of one int or generator, or the
    seeds of a sequence of ``n`` ints or generators, taken as they are."""
    if not isinstance(rng, (int, np.integer, torch.Generator)):
        if len(rng) != n:
            raise ValueError(f"per-fold rng has {len(rng)} seeds, need {n}")
        return [as_seed(r) for r in rng]
    root = as_seed(rng)
    return [fold_in(root, i) for i in range(n)]


def fold_rngs(seed: int, device) -> FoldRng:
    """The streams of the fold with ``seed``, as the JAX package's ``fit``
    splits a fold's key into the shuffle, init and dropout keys."""
    return FoldRng(init=generator(fold_in(seed, 1)),
                   dropout_seed=fold_in(seed, 2),
                   shuffle=generator(fold_in(seed, 0), device))


def start_fold(model: nn.Module, rngs: FoldRng,
               variables: Optional[Mapping] = None) -> None:
    """Fresh weights for a fold, in place: the flax ``variables``
    ({'params', 'batch_stats'}) if given, else ``init_weights`` from the
    fold's init generator; and the device's default generator seeded for
    the fold's dropout."""
    # convert imports train.fit, so it is imported when first used
    from multimodal_eeg_fmri_tpu_torch.convert import (
        init_weights,
        load_flax_variables,
    )

    if variables is None:
        init_weights(model, rngs.init)
    else:
        load_flax_variables(model, variables["params"],
                            variables.get("batch_stats"))
    device_generator(next(model.parameters()).device).manual_seed(
        rngs.dropout_seed)


def _fork_rng(device: torch.device):
    """Restores the CPU's default generator, and the card's if ``device``
    is one, when the block ends."""
    cards = []
    if device.type == "cuda":
        cards = [device.index if device.index is not None
                 else torch.cuda.current_device()]
    return torch.random.fork_rng(devices=cards)


def _fold(stack: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    return {k: v[i] for k, v in stack.items()}


def _check_initial(initial_variables, n: int) -> None:
    if initial_variables is not None and len(initial_variables) != n:
        raise ValueError(f"initial_variables has {len(initial_variables)} "
                         f"entries, need {n}")


def run_cv(
    model: nn.Module,
    cfg: TrainConfig,
    data: Dict[str, np.ndarray],
    splits: Sequence[Split],
    *,
    task: str = "classification",
    augment: Optional[Callable] = None,
    normalize: str = "scalar",
    normalize_keys: Sequence[str] = (),
    mesh_plan=None,
    rng: Union[Seed, Sequence[Seed], None] = None,
    num_epochs: Optional[int] = None,
    aot_dir: Optional[str] = None,
    initial_variables: Optional[Sequence[Mapping]] = None,
) -> CVResult:
    """Train one model architecture across all folds, one after another,
    each from fresh weights, on the model's device (the module is trained
    in place and left at the last fold's final weights).

    ``rng`` (default ``cfg.seed``) and ``initial_variables`` (one flax
    variable dict per fold) are described in the module's docstring.
    ``mesh_plan`` and ``aot_dir`` are not ported and raise."""
    if mesh_plan is not None:
        raise NotImplementedError(
            "mesh_plan is not ported yet (ROADMAP.md, queue A item 7: "
            "parallel axes on torch.distributed)")
    if aot_dir is not None:
        raise NotImplementedError(
            "aot_dir is not ported: core/aot.py (jax.export bundles) is "
            "dropped (ROADMAP.md, queue A item 8)")
    # 'subject' rides along in the stacks (split_batch keeps it out of the
    # model inputs) so LOSO votes and per-subject reports can use it.
    validate_dataset(data, require_label=task == "classification",
                     num_classes=getattr(cfg, "num_classes", 2),
                     name="run_cv data",
                     # build_fold_arrays adds per-fold padding masks itself
                     warn_missing_weight=False)
    model_data = {k: np.asarray(v) for k, v in data.items()}
    train_stack, eval_stacks, cw = build_fold_arrays(
        model_data, splits, normalize, normalize_keys,
        weighted_classes=cfg.loss == "weighted_ce" and task == "classification",
    )
    n_folds = len(splits)
    seeds = fold_seeds(cfg.seed if rng is None else rng, n_folds)
    _check_initial(initial_variables, n_folds)
    fit_fn = make_fit_fn(model, cfg, num_epochs=num_epochs, task=task,
                         eval_names=tuple(eval_stacks), augment=augment)
    dev = next(model.parameters()).device

    fits, metrics, probs = [], [], []
    with _fork_rng(dev):
        for i in range(n_folds):
            rngs = fold_rngs(seeds[i], dev)
            start_fold(model, rngs, None if initial_variables is None
                       else initial_variables[i])
            res = fit_fn(rngs.shuffle, _fold(train_stack, i),
                         {name: _fold(s, i) for name, s in eval_stacks.items()},
                         cw[i])
            # final test metrics from the selected (best) state
            m, out = evaluate_dataset(model, res.params, res.batch_stats,
                                      _fold(eval_stacks["test"], i), task)
            fits.append(res)
            metrics.append(m)
            probs.append(out.logits if task == "regression"
                         else torch.softmax(out.logits.float(), dim=-1))

    def host(tensors):
        return torch.stack(tensors).cpu().numpy()

    fold_metrics = {k: host([m[k] for m in metrics]) for k in metrics[0]}
    summary = {
        k: (float(np.mean(v)), float(np.std(v))) for k, v in fold_metrics.items()
    }
    test_np = eval_stacks["test"]
    return CVResult(
        fold_metrics=fold_metrics,
        summary=summary,
        params={k: torch.stack([r.params[k] for r in fits])
                for k in fits[0].params},
        batch_stats={k: torch.stack([r.batch_stats[k] for r in fits])
                     for k in fits[0].batch_stats},
        history={k: host([r.history[k] for r in fits])
                 for k in fits[0].history},
        best_epochs=host([r.best_epoch for r in fits]),
        n_folds=n_folds,
        test_probs=host(probs),
        test_labels=test_np["label"],
        test_weight=test_np["weight"],
        test_subjects=test_np.get("subject"),
    )


def run_model_suite(
    models: Dict[str, Any],
    cfg: TrainConfig,
    data: Dict[str, np.ndarray],
    splits: Sequence[Split],
    **kw,
) -> Dict[str, CVResult]:
    """Train several architectures over the same folds (the reference's
    4-models-per-fold / 3-models-per-fold comparisons), back to back."""
    return {name: run_cv(m, cfg, data, splits, **kw)
            for name, m in models.items()}


def run_seed_sweep(
    model: nn.Module,
    cfg: TrainConfig,
    train_data: Dict[str, np.ndarray],
    eval_sets: Dict[str, Dict[str, np.ndarray]],
    n_seeds: int,
    *,
    class_weights=None,
    mesh_plan=None,
    base_seed: int = 0,
    task: str = "classification",
    initial_variables: Optional[Sequence[Mapping]] = None,
) -> Dict[str, Any]:
    """Train ``n_seeds`` runs differing ONLY in the seed, one after another
    (the JAX package vmaps them), and summarize the spread.

    The reference reports mean±std across FOLDS only
    (`CrossModal_EEG_scr.ipynb §44`); at 66 subjects the run-to-run
    variance of training itself (init + shuffling + dropout masks) is the
    other half of the uncertainty. Seed ``i`` takes the streams of
    ``fold_in(base_seed, i)`` as a CV fold does, or ``initial_variables[i]``
    as its weights.

    Returns ``{"best_metric": (S,), "mean", "std", "ci95": (lo, hi),
    "history": {metric: (S, epochs)}, "result": [FitResult per seed]}``;
    the CI is the t-distribution interval
    (`report/stats.confidence_interval`, reference §28).
    """
    if mesh_plan is not None:
        raise NotImplementedError(
            "mesh_plan is not ported yet (ROADMAP.md, queue A item 7: "
            "parallel axes on torch.distributed)")
    validate_dataset(train_data, require_label=task == "classification",
                     num_classes=getattr(cfg, "num_classes", 2),
                     name="seed_sweep train_data")
    _check_initial(initial_variables, n_seeds)
    fit = make_fit_fn(model, cfg, eval_names=tuple(eval_sets), task=task)
    dev = next(model.parameters()).device
    results: List[FitResult] = []
    with _fork_rng(dev):
        for i, seed in enumerate(fold_seeds(base_seed, n_seeds)):
            rngs = fold_rngs(seed, dev)
            start_fold(model, rngs, None if initial_variables is None
                       else initial_variables[i])
            results.append(fit(rngs.shuffle, train_data, eval_sets,
                               class_weights))
    best = torch.stack([r.best_metric for r in results]).cpu().numpy()
    mean, lo, hi = confidence_interval(best)
    return {
        "best_metric": best,
        "mean": mean,
        "std": float(best.std(ddof=1)) if n_seeds > 1 else 0.0,
        "ci95": (lo, hi),
        "history": {k: torch.stack([r.history[k] for r in results]).cpu()
                    .numpy() for k in results[0].history},
        "result": results,
    }


# ---------------------------------------------------------------------------
# Protocol front-ends matching the reference's protocols
# ---------------------------------------------------------------------------

def eeg_kfold_splits(data, cfg: TrainConfig, n_splits=5, val_ratio=0.2):
    return stratified_group_kfold(
        data["label"], data.get("subject", np.arange(len(data["label"]))),
        n_splits=n_splits, val_ratio=val_ratio, seed=cfg.seed,
    )


def fmri_kfold_splits(data, cfg: TrainConfig, n_splits=5, val_ratio=0.15,
                      stratify=True):
    return stratified_kfold(data["label"], n_splits=n_splits,
                            val_ratio=val_ratio, seed=cfg.seed,
                            stratify=stratify)


def loso_splits(data, cfg: TrainConfig, val_ratio=None):
    """LOSO folds. Default: a leakage-free 15% inner val split over the
    remaining subjects; the reference-faithful leaky mode (val == test
    subject) is opt-in via explicit ``val_ratio=0`` (see
    ``data.splits.leave_one_subject_out``)."""
    return leave_one_subject_out(
        data.get("subject", np.arange(len(data["label"]))),
        val_ratio=val_ratio, labels=data["label"], seed=cfg.seed,
    )


def loocv_splits(data):
    return leave_one_out(len(data["label"]))


def subject_level_votes(result: CVResult) -> Dict[int, int]:
    """LOSO majority vote per held-out subject
    (``run_loso_subject_evaluation``, ``CrossModal_EEG_scr.ipynb §31``):
    each fold's test samples belong to one subject; the vote is the mean
    class-1 probability thresholded at 0.5 over that subject's samples.
    (The reference rounds the mean of HARD argmax predictions; the mean
    soft probability is the smoother equivalent and, unlike np.round's
    banker's rounding, has no even-count tie artifact.)"""
    votes = {}
    for f in range(result.n_folds):
        w = result.test_weight[f] > 0
        if result.test_subjects is None or not w.any():
            continue
        subj = int(result.test_subjects[f][w][0])
        p1 = result.test_probs[f][w][:, 1].mean()
        votes[subj] = int(p1 > 0.5)
    return votes
