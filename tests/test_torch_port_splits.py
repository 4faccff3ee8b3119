"""The port's sklearn-free splits and per-fold normalization.

The references are scikit-learn itself (imported here only, for the
private numpy versions of its splitters) and the JAX package's numpy
modules ``data/splits.py``, ``data/normalize.py`` and ``data/arrays.py``;
no JAX function runs. Hypothesis draws cohorts of subjects with 1-6
samples each and 2-3 classes (some smaller than ``n_splits``),
``n_splits`` in 2..6, ``val_ratio`` in {0, 0.15, 0.2}, seeds, and
stratification on and off: the port gives exactly the indices, in the same
order and dtype, that the JAX package gives, or raises ``ValueError`` where
it raises. Normalization, stacking and padding equal the JAX package's to
0 ulp. And the digest of the chip smoke run's cohorts (its gate c) is
recomputed from the JAX package's splits.
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import (
    GroupShuffleSplit,
    KFold,
    StratifiedGroupKFold,
    StratifiedKFold,
    StratifiedShuffleSplit,
    train_test_split,
)
from sklearn.utils.extmath import _approximate_mode

import chip_smoke
from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import arrays as j_arrays
from multimodal_eeg_fmri_tpu.data import normalize as j_normalize
from multimodal_eeg_fmri_tpu.data import splits as j_splits
from multimodal_eeg_fmri_tpu.data import synthetic as j_synthetic
from multimodal_eeg_fmri_tpu_torch.data import arrays as t_arrays
from multimodal_eeg_fmri_tpu_torch.data import normalize as t_normalize
from multimodal_eeg_fmri_tpu_torch.data import splits as t_splits

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
EXAMPLES = settings(max_examples=50, deadline=None)


@st.composite
def cohorts(draw):
    """(labels, groups) of 3-24 subjects with 1-6 samples each; a subject's
    samples share its label."""
    n_classes = draw(st.integers(2, 3))
    per_subject = draw(st.lists(st.integers(1, 6), min_size=3, max_size=24))
    labels = draw(st.lists(st.integers(0, n_classes - 1),
                           min_size=len(per_subject),
                           max_size=len(per_subject)))
    groups = np.repeat(np.arange(10, 10 + len(per_subject)), per_subject)
    return np.repeat(np.asarray(labels), per_subject), groups


def _outcome(fn, *args, **kw):
    """The splits, or the exception type."""
    try:
        return fn(*args, **kw)
    except ValueError:
        return ValueError


def _same_splits(got, want):
    if want is ValueError or got is ValueError:
        assert got is want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.fold == w.fold
        for f in ("train", "val", "test"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _same_pairs(got, want):
    if want is ValueError or got is ValueError:
        assert got is want
        return
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))


N_SPLITS = st.integers(2, 6)
VAL_RATIO = st.sampled_from([0.0, 0.15, 0.2])
SEEDS = st.integers(0, 2**31 - 1)


# --- the front-ends against the JAX package's --------------------------------

@EXAMPLES
@given(cohorts(), N_SPLITS, VAL_RATIO, SEEDS)
def test_stratified_group_kfold_matches_jax(cohort, n_splits, val_ratio,
                                            seed):
    labels, groups = cohort
    kw = dict(n_splits=n_splits, val_ratio=val_ratio, seed=seed)
    _same_splits(_outcome(t_splits.stratified_group_kfold, labels, groups,
                          **kw),
                 _outcome(j_splits.stratified_group_kfold, labels, groups,
                          **kw))


@EXAMPLES
@given(cohorts(), N_SPLITS, VAL_RATIO, SEEDS, st.booleans())
def test_stratified_kfold_matches_jax(cohort, n_splits, val_ratio, seed,
                                      stratify):
    labels, _ = cohort
    kw = dict(n_splits=n_splits, val_ratio=val_ratio, seed=seed,
              stratify=stratify)
    _same_splits(_outcome(t_splits.stratified_kfold, labels, **kw),
                 _outcome(j_splits.stratified_kfold, labels, **kw))


@EXAMPLES
@given(cohorts(), st.sampled_from([None, 0.0, 0.15, 0.2, 0.5]), SEEDS)
def test_leave_one_subject_out_matches_jax(cohort, val_ratio, seed):
    labels, groups = cohort
    with warnings.catch_warnings(record=True) as got_warnings:
        warnings.simplefilter("always")
        got = t_splits.leave_one_subject_out(groups, val_ratio, labels, seed)
    with warnings.catch_warnings(record=True) as want_warnings:
        warnings.simplefilter("always")
        want = j_splits.leave_one_subject_out(groups, val_ratio, labels, seed)
    _same_splits(got, want)
    assert ([str(w.message) for w in got_warnings]
            == [str(w.message) for w in want_warnings])


@pytest.mark.parametrize("n", [1, 2, 7])
def test_leave_one_out_matches_jax(n):
    _same_splits(t_splits.leave_one_out(n), j_splits.leave_one_out(n))


def test_regression_labels_split_as_jax():
    """Plain k-fold over float labels (the regression protocol), and the
    continuous-target error of the stratified one."""
    labels = np.random.default_rng(0).normal(size=20).astype(np.float32)
    kw = dict(n_splits=3, val_ratio=0.15, seed=5)
    _same_splits(t_splits.stratified_kfold(labels, stratify=False, **kw),
                 j_splits.stratified_kfold(labels, stratify=False, **kw))
    for fn in (t_splits.stratified_kfold, j_splits.stratified_kfold):
        with pytest.raises(ValueError, match="continuous"):
            fn(labels, **kw)


# --- the private numpy versions against the sklearn classes -------------------

@EXAMPLES
@given(cohorts(), N_SPLITS, SEEDS)
def test_numpy_kfolds_match_sklearn(cohort, n_splits, seed):
    labels, groups = cohort
    x = np.zeros(len(labels))
    _same_pairs(
        _outcome(lambda: list(t_splits._stratified_group_kfold(
            labels, groups, n_splits, seed))),
        _outcome(lambda: list(StratifiedGroupKFold(
            n_splits, shuffle=True, random_state=seed).split(x, labels,
                                                             groups))))
    _same_pairs(
        _outcome(lambda: list(t_splits._stratified_kfold(
            labels, n_splits, True, seed))),
        _outcome(lambda: list(StratifiedKFold(
            n_splits, shuffle=True, random_state=seed).split(x, labels))))
    for shuffle in (False, True):
        _same_pairs(
            _outcome(lambda: list(t_splits._kfold(len(labels), n_splits,
                                                  shuffle, seed))),
            _outcome(lambda: list(KFold(
                n_splits, shuffle=shuffle,
                random_state=seed if shuffle else None).split(x))))


@EXAMPLES
@given(cohorts(), st.sampled_from([0.1, 0.15, 0.2, 0.5]), SEEDS)
def test_numpy_shuffle_splits_match_sklearn(cohort, test_size, seed):
    labels, groups = cohort
    idx = np.arange(100, 100 + len(labels))
    _same_pairs(
        _outcome(lambda: [t_splits._group_shuffle_split(groups, test_size,
                                                        seed)]),
        _outcome(lambda: [next(GroupShuffleSplit(
            n_splits=1, test_size=test_size, random_state=seed).split(
                idx, labels, groups))]))
    for stratify in (None, labels):
        _same_pairs(
            _outcome(lambda: [t_splits._train_test_split(
                idx, test_size, seed, stratify)]),
            _outcome(lambda: [train_test_split(
                idx, test_size=test_size, random_state=seed,
                stratify=stratify)]))
    n = len(labels)
    n_test = max(1, n // 3)
    _same_pairs(
        _outcome(lambda: [t_splits._stratified_shuffle_split(
            labels, n - n_test, n_test, seed)]),
        _outcome(lambda: [next(StratifiedShuffleSplit(
            n_splits=1, test_size=n_test, train_size=n - n_test,
            random_state=seed).split(idx, labels))]))


@EXAMPLES
@given(st.lists(st.integers(1, 9), min_size=1, max_size=6),
       st.integers(0, 30), SEEDS)
def test_approximate_mode_matches_sklearn(counts, draws, seed):
    counts = np.asarray(counts)
    draws = min(draws, int(counts.sum()))
    got_rng, want_rng = (np.random.RandomState(seed) for _ in range(2))
    got = t_splits._approximate_mode(counts, draws, got_rng)
    np.testing.assert_array_equal(got,
                                  _approximate_mode(counts, draws, want_rng))
    # the same draws from the generator, for the next consumer
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


# --- gate c of chip_smoke.py ------------------------------------------------

def _cv_protocols(splits_of, cfg):
    """The split front-ends on the chip smoke run's cohorts, as its cv
    phase calls them (``chip_smoke.cv_protocols``)."""
    eeg = j_synthetic.synthetic_eeg_trimodal(n_subjects=chip_smoke.CV_EEG_N)
    fmri = j_synthetic.synthetic_fmri(n_subjects=chip_smoke.CV_FMRI_N)
    return [splits_of.stratified_group_kfold(
                eeg["label"], eeg["subject"], n_splits=5, val_ratio=0.2,
                seed=cfg.seed),
            splits_of.stratified_kfold(fmri["label"], n_splits=5,
                                       val_ratio=0.15, seed=cfg.seed),
            splits_of.leave_one_subject_out(fmri["subject"],
                                            labels=fmri["label"],
                                            seed=cfg.seed)]


def test_chip_smoke_split_digest_is_the_jax_packages():
    from multimodal_eeg_fmri_tpu.train import cv as j_cv

    cfg = JTrainConfig()
    want = _cv_protocols(j_splits, cfg)
    # the JAX package's front-ends call these functions so
    eeg = j_synthetic.synthetic_eeg_trimodal(n_subjects=chip_smoke.CV_EEG_N)
    fmri = j_synthetic.synthetic_fmri(n_subjects=chip_smoke.CV_FMRI_N)
    for got, ref in zip(want, [j_cv.eeg_kfold_splits(eeg, cfg),
                               j_cv.fmri_kfold_splits(fmri, cfg),
                               j_cv.loso_splits(fmri, cfg)]):
        _same_splits(got, ref)
    digest = chip_smoke.splits_sha256(want)
    assert digest == chip_smoke.CV_SPLITS_SHA256
    assert chip_smoke.splits_sha256(chip_smoke.cv_protocols(cfg)) == digest


def test_splits_digest_sees_every_index():
    base = t_splits.leave_one_out(4)
    reordered = list(base)
    reordered[1] = t_splits.Split(base[1].train[::-1], base[1].val,
                                  base[1].test, 1)
    swapped = list(base)
    swapped[2] = t_splits.Split(base[2].val, base[2].train, base[2].test, 2)
    digests = {chip_smoke.splits_sha256([s])
               for s in (base, reordered, swapped, base[:3])}
    assert len(digests) == 4


# --- normalization, stacking, padding -----------------------------------------

def _dataset(n, seed):
    r = np.random.default_rng(seed)
    return {"erp": r.normal(2.0, 3.0, (n, 8, 3)).astype(np.float32),
            "conn": r.normal(-1.0, 0.5, (n, 5)).astype(np.float32),
            "label": r.integers(0, 2, n).astype(np.int32)}


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_normalizers_match_jax():
    data = _dataset(12, 1)
    train = np.array([0, 2, 3, 5, 8, 11])
    t_norm = t_normalize.FoldNormalizer(("erp", "conn")).fit(data, train)
    j_norm = j_normalize.FoldNormalizer(("erp", "conn")).fit(data, train)
    assert t_norm.stats == j_norm.stats
    _equal(t_norm.transform(data), j_norm.transform(data))
    _equal(t_normalize.feature_standardize(data, train, ("erp", "conn")),
           j_normalize.feature_standardize(data, train, ("erp", "conn")))


def test_stacking_and_padding_match_jax():
    folds = [_dataset(n, n) for n in (5, 7, 3)]
    for multiple in (1, 4):
        _equal(t_arrays.pad_and_stack(folds, multiple),
               j_arrays.pad_and_stack(folds, multiple))
    same = [_dataset(4, s) for s in range(3)]
    _equal(t_arrays.stack_trees(same), j_arrays.stack_trees(same))
    for labels in (None, np.array([0, 1] * 10)):
        for ratio in (0.0, 0.2):
            got = t_arrays.train_val_split(20, ratio,
                                           np.random.default_rng(3), labels)
            want = j_arrays.train_val_split(20, ratio,
                                            np.random.default_rng(3), labels)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_synthetic_cohorts_match_jax():
    from multimodal_eeg_fmri_tpu_torch.data import synthetic as t_synthetic

    for name, kw in (("synthetic_eeg_trimodal", dict(n_subjects=6,
                                                     time_steps=16)),
                     ("synthetic_eeg_trimodal", dict(n_subjects=4,
                                                     conn_as_matrix=True)),
                     ("synthetic_fmri", dict(seed=2)),
                     ("synthetic_bridge", dict(n_subjects=5, seed=1))):
        _equal(getattr(t_synthetic, name)(**kw),
               getattr(j_synthetic, name)(**kw))
