"""Cross-validation split generation (host-side numpy). Counterpart of
``multimodal_eeg_fmri_tpu/data/splits.py``, without scikit-learn.

Split *identity* matters for parity with the reference: the JAX package
calls sklearn's StratifiedGroupKFold / GroupShuffleSplit / StratifiedKFold /
KFold / train_test_split with fixed ``random_state``. The port's machine has
no sklearn, so the private functions below re-implement those algorithms on
``np.random.RandomState`` (what sklearn's ``check_random_state(int)``
returns), drawing from it in the same order, so that the same seeds give the
same indices in the same order. They were held against scikit-learn 1.9.0
(``sklearn/model_selection/_split.py``, ``sklearn/utils/extmath.py:
_approximate_mode``) by ``tests/test_torch_port_splits.py``. They raise
``ValueError`` where sklearn's do, for the inputs the split front-ends give
them.

Reference protocols these reproduce:
- ``run_stratified_group_kfold_trimodal`` (``CrossModal_EEG_scr.ipynb §30``):
  SGKF(5, shuffle, seed) grouped by subject + inner GroupShuffleSplit(0.2).
- ``run_experiment`` (``run_fmri_v11.py:715-931``): StratifiedKFold(5) (or
  KFold for regression) + inner stratified train_test_split(0.15).
- LOSO (``CrossModal_EEG_scr.ipynb §31``, ``CrossModal_fmri_scr.ipynb §12``):
  leave-one-subject-out over unique subjects.
- Bridge LOOCV (``_test_bridge.py:826-989``): LeaveOneOut over subjects.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from math import ceil
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

IndexPair = Tuple[np.ndarray, np.ndarray]


@dataclass(frozen=True)
class Split:
    """Index triple into a sample-axis dataset."""

    train: np.ndarray
    val: np.ndarray
    test: np.ndarray
    fold: int


# --- the sklearn algorithms, on numpy ----------------------------------------

def _class_labels(y: np.ndarray) -> np.ndarray:
    """``y`` as 1-D class labels; raises as sklearn's ``type_of_target``
    check does for a continuous target."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {y.shape}")
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        raise ValueError("Supported target types are: ('binary', "
                         "'multiclass'). Got 'continuous' instead.")
    return y


def _check_n_splits(n_splits: int, n_samples: int) -> None:
    if n_splits > n_samples:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: "
                         f"n_samples={n_samples}.")


def _masks_to_pairs(n: int, test_sets: Iterable[np.ndarray]
                    ) -> Iterator[IndexPair]:
    """sklearn's ``BaseCrossValidator.split``: each test set as a mask,
    so train and test come out in ascending order."""
    indices = np.arange(n)
    for test in test_sets:
        mask = np.zeros(n, dtype=bool)
        mask[test] = True
        yield indices[~mask], indices[mask]


def _kfold(n: int, n_splits: int, shuffle: bool, seed: Optional[int]
           ) -> Iterator[IndexPair]:
    """``KFold(n_splits, shuffle, random_state=seed).split``."""
    _check_n_splits(n_splits, n)
    indices = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return _masks_to_pairs(
        n, (indices[a:b] for a, b in zip(bounds[:-1], bounds[1:])))


def _min_class_warning(n_splits: int, counts: np.ndarray) -> None:
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only "
                      f"{counts.min()} members, which is less than "
                      f"n_splits={n_splits}.", UserWarning)


def _stratified_kfold(y: np.ndarray, n_splits: int, shuffle: bool,
                      seed: Optional[int]) -> Iterator[IndexPair]:
    """``StratifiedKFold(n_splits, shuffle, random_state=seed).split``:
    classes encoded in order of first appearance, a round robin over the
    sorted codes allocates each class's count per fold, and each class's
    block of fold numbers is shuffled in turn."""
    y = _class_labels(y)
    _check_n_splits(n_splits, len(y))
    rng = np.random.RandomState(seed)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    _min_class_warning(n_splits, np.bincount(y_encoded))
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return _masks_to_pairs(
        len(y), (np.flatnonzero(test_folds == i) for i in range(n_splits)))


def _sgkf_best_fold(counts_per_fold: np.ndarray, y_cnt: np.ndarray,
                    group_counts: np.ndarray) -> int:
    best, min_eval, min_samples = None, np.inf, np.inf
    for i in range(len(counts_per_fold)):
        counts_per_fold[i] += group_counts
        std_per_class = np.std(counts_per_fold / y_cnt.reshape(1, -1),
                               axis=0)
        counts_per_fold[i] -= group_counts
        fold_eval = np.mean(std_per_class)
        samples = np.sum(counts_per_fold[i])
        if fold_eval < min_eval or (np.isclose(fold_eval, min_eval)
                                    and samples < min_samples):
            best, min_eval, min_samples = i, fold_eval, samples
    return best


def _stratified_group_kfold(y: np.ndarray, groups: np.ndarray,
                            n_splits: int, seed: Optional[int]
                            ) -> Iterator[IndexPair]:
    """``StratifiedGroupKFold(n_splits, shuffle=True, random_state=seed)
    .split``: the groups in a shuffled order, then stably sorted by the
    spread of their class counts, each placed in the fold that keeps the
    class shares most even (ties to the fold with fewer samples)."""
    y = _class_labels(y)
    _check_n_splits(n_splits, len(y))
    rng = np.random.RandomState(seed)
    _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
    _min_class_warning(n_splits, y_cnt)
    _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True,
                                          return_counts=True)
    n_groups = len(groups_cnt)
    if n_splits > n_groups:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of groups: {n_groups}.")
    counts_per_group = np.zeros((n_groups, len(y_cnt)))
    np.add.at(counts_per_group, (groups_inv, y_inv), 1)
    perm = np.arange(n_groups)
    rng.shuffle(perm)
    counts_per_group = counts_per_group[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_groups)
    groups_inv = inv_perm[groups_inv]
    order = np.argsort(-np.std(counts_per_group, axis=1), kind="stable")
    counts_per_fold = np.zeros((n_splits, len(y_cnt)))
    fold_of_group = np.empty(n_groups, dtype=int)
    for g in order:
        best = _sgkf_best_fold(counts_per_fold, y_cnt, counts_per_group[g])
        counts_per_fold[best] += counts_per_group[g]
        fold_of_group[g] = best
    fold_of_row = fold_of_group[groups_inv]
    return _masks_to_pairs(
        len(y), (np.flatnonzero(fold_of_row == i) for i in range(n_splits)))


def _shuffle_split_sizes(n: int, test_size: float) -> Tuple[int, int]:
    """(n_train, n_test) of sklearn's ``_validate_shuffle_split`` for a float
    ``test_size`` and no ``train_size``: the test side is the ceiling."""
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be either positive "
                         f"and smaller than the number of samples {n} or a "
                         f"float in the (0, 1) range")
    n_test = ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and "
                         f"train_size=None, the resulting train set will be "
                         f"empty. Adjust any of the aforementioned "
                         f"parameters.")
    return n_train, n_test


def _shuffle_split(n: int, n_train: int, n_test: int, seed: Optional[int]
                   ) -> IndexPair:
    """The first split of ``ShuffleSplit(test_size=n_test,
    train_size=n_train, random_state=seed)``: one permutation, test first."""
    if not (0 < n_test < n and 0 < n_train < n):
        raise ValueError(f"test_size={n_test} and train_size={n_train} must "
                         f"be positive and smaller than the number of "
                         f"samples {n}")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def _group_shuffle_split(groups: np.ndarray, test_size: float,
                         seed: Optional[int]) -> IndexPair:
    """The first split of ``GroupShuffleSplit(n_splits=1, test_size,
    random_state=seed)``: a shuffle split of the unique groups, mapped back
    to rows in ascending order."""
    classes, group_indices = np.unique(groups, return_inverse=True)
    n_train, n_test = _shuffle_split_sizes(len(classes), test_size)
    group_train, group_test = _shuffle_split(len(classes), n_train, n_test,
                                             seed)
    return (np.flatnonzero(np.isin(group_indices, group_train)),
            np.flatnonzero(np.isin(group_indices, group_test)))


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: the floored share of each class,
    the leftover draws given by descending remainder, ties broken by
    ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y: np.ndarray, n_train: int, n_test: int,
                              seed: Optional[int]) -> IndexPair:
    """The first split of ``StratifiedShuffleSplit(test_size=n_test,
    train_size=n_train, random_state=seed)``: per-class counts by
    ``_approximate_mode``, a permutation per class, then both sides
    permuted."""
    y = np.asarray(y)
    n = len(y)
    if not (0 < n_test < n and 0 < n_train < n):
        raise ValueError(f"test_size={n_test} and train_size={n_train} must "
                         f"be positive and smaller than the number of "
                         f"samples {n}")
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = len(classes)
    if class_counts.min() < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            f"less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _train_test_split(idx: np.ndarray, test_size: float, seed: int,
                      stratify: Optional[np.ndarray] = None) -> IndexPair:
    """``train_test_split(idx, test_size=..., random_state=seed,
    stratify=...)``: the rows of ``idx`` in the splitter's permuted
    order."""
    n_train, n_test = _shuffle_split_sizes(len(idx), test_size)
    if stratify is None:
        tr, te = _shuffle_split(len(idx), n_train, n_test, seed)
    else:
        tr, te = _stratified_shuffle_split(stratify, n_train, n_test, seed)
    return idx[tr], idx[te]


# --- the split front-ends -----------------------------------------------------

def stratified_group_kfold(
    labels: np.ndarray,
    groups: np.ndarray,
    n_splits: int = 5,
    val_ratio: float = 0.2,
    seed: int = 42,
) -> List[Split]:
    """SGKF grouped by subject with an inner group-shuffle val split."""
    labels = np.asarray(labels)
    groups = np.asarray(groups)
    splits = []
    for fold, (train_idx, test_idx) in enumerate(
            _stratified_group_kfold(labels, groups, n_splits, seed)):
        if val_ratio > 0:
            tr, va = _group_shuffle_split(groups[train_idx], val_ratio,
                                          seed + fold)
            splits.append(Split(train_idx[tr], train_idx[va], test_idx, fold))
        else:
            splits.append(Split(train_idx, test_idx, test_idx, fold))
    return splits


def stratified_kfold(
    labels: np.ndarray,
    n_splits: int = 5,
    val_ratio: float = 0.15,
    seed: int = 42,
    stratify: bool = True,
) -> List[Split]:
    """StratifiedKFold (or plain KFold) + inner stratified val split —
    the fMRI v11 leakage-free protocol."""
    labels = np.asarray(labels)
    folds = (_stratified_kfold(labels, n_splits, True, seed) if stratify
             else _kfold(len(labels), n_splits, True, seed))
    splits = []
    for fold, (train_idx, test_idx) in enumerate(folds):
        if val_ratio > 0:
            tr, va = _train_test_split(
                train_idx, val_ratio, seed + fold,
                labels[train_idx] if stratify else None)
            splits.append(Split(tr, va, test_idx, fold))
        else:
            splits.append(Split(train_idx, test_idx, test_idx, fold))
    return splits


def leave_one_subject_out(
    subjects: np.ndarray,
    val_ratio: Optional[float] = None,
    labels: Optional[np.ndarray] = None,
    seed: int = 42,
) -> List[Split]:
    """One fold per unique subject; that subject's samples are the test set.

    ``val_ratio=None`` (the default) carves a leakage-free inner val split
    of 15% of the REMAINING subjects, so ``selection='val'`` never sees the
    held-out test subject. The reference's LOSO instead lets val alias the
    test subject — test-set model selection, the leakage documented in
    SURVEY §2.5 — and that mode is OPT-IN via an explicit ``val_ratio=0``
    (the golden-protocol replays use it to reproduce the reference
    bit-for-bit); it warns every time."""
    if val_ratio is None:
        val_ratio = 0.15
    subjects = np.asarray(subjects)
    uniq = np.unique(subjects)
    rng = np.random.default_rng(seed)
    splits = []
    leaky_folds = 0
    for fold, s in enumerate(uniq):
        test_idx = np.where(subjects == s)[0]
        rest = np.where(subjects != s)[0]
        rest_subj = np.unique(subjects[rest])
        if val_ratio > 0 and len(rest_subj) >= 2:
            n_val = min(max(1, int(round(len(rest_subj) * val_ratio))),
                        len(rest_subj) - 1)
            val_subj = rng.choice(rest_subj, size=n_val, replace=False)
            va = rest[np.isin(subjects[rest], val_subj)]
            tr = rest[~np.isin(subjects[rest], val_subj)]
        else:
            tr, va = rest, test_idx
            leaky_folds += 1
        splits.append(Split(tr, va, test_idx, fold))
    if leaky_folds:
        warnings.warn(
            f"leave_one_subject_out: {leaky_folds} fold(s) have val "
            "ALIASING the TEST subject"
            + (" (explicit val_ratio=0 — the reference-faithful mode)"
               if val_ratio <= 0 else
               " (too few remaining subjects to carve an inner split)")
            + ", so selection='val' becomes test-set model selection "
            "(leaky). Use the default val_ratio, or select on "
            "'train_loss'/'test' explicitly.", stacklevel=2)
    return splits


def leave_one_out(n: int) -> List[Split]:
    """LOOCV over samples (bridge protocol: selection on train loss)."""
    idx = np.arange(n)
    return [
        Split(np.delete(idx, i), np.asarray([i]), np.asarray([i]), i)
        for i in range(n)
    ]

