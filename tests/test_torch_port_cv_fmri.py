"""The port's fMRI cross-validation runs against the JAX package's.

``run_cv`` of a narrow ``FMRIFusionNet`` regression (hidden 16, dropout 0)
over 20 synthetic subjects, the regression label as ``pipelines.py`` sets
it, in 3 plain k-folds (``fmri_kfold_splits(stratify=False)``) with
per-feature normalization, 2 epochs with a batch that holds the whole
padded fold; and ``run_seed_sweep`` of the classification net over 2 seeds
on 12 training and 4 validation subjects. Each fold or seed of the port
starts from the flax variables the JAX package's ``fit`` initialises from
its key (``test_torch_port_cv.py``'s helpers). The JAX runs are
module-scoped and shared by the tests of the file.

Tolerances: MSE, MAE, RMSE and R² per fold, histories, the test
predictions, the sweep's best metrics, mean, std and t interval within 1e-4
(whole fits); best epochs exactly equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest
from test_torch_port_cv import (
    FMRI,
    FMRI_KEYS,
    _cfg,
    _close,
    _fold_keys,
    _fold_variables,
    _initial_variables,
    _padded_train_rows,
    _port_cfg,
    _same_history_and_metrics,
    flax_dropout_off,
)

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import synthetic as j_synthetic
from multimodal_eeg_fmri_tpu.models.fmri import FMRIFusionNet as JFMRI
from multimodal_eeg_fmri_tpu.report import stats as j_stats
from multimodal_eeg_fmri_tpu_torch.data import synthetic as t_synthetic
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet as TFMRI
from multimodal_eeg_fmri_tpu_torch.report import stats as t_stats

j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")

CLASS_WEIGHTS = np.array([0.8, 1.3], np.float32)


def _reg_data(synthetic):
    data = synthetic.synthetic_fmri(n_subjects=20, seed=4)
    data["label"] = data.pop("reg_label").astype(np.float32)
    return data


def _sweep_data(synthetic):
    data = synthetic.synthetic_fmri(n_subjects=16, seed=5,
                                    with_regression=False)
    return ({k: v[:12] for k, v in data.items()},
            {"val": {k: v[12:] for k, v in data.items()}})


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with flax_dropout_off():
        data = _reg_data(j_synthetic)
        cfg = _cfg(JTrainConfig, 1)
        splits = j_cv.fmri_kfold_splits(data, cfg, n_splits=3,
                                        stratify=False)
        bsz = _padded_train_rows(data, splits, FMRI_KEYS, "feature")
        cfg = dataclasses.replace(cfg, batch_size=bsz)
        fmod = JFMRI(task="regression", **FMRI)
        res = j_cv.run_cv(fmod, cfg, data, splits, task="regression",
                          normalize="feature", normalize_keys=FMRI_KEYS)
        stacks = j_cv.build_fold_arrays(data, splits, "feature", FMRI_KEYS,
                                        weighted_classes=False)
        out["reg"] = dict(cfg=cfg, result=res,
                          variables=_fold_variables(fmod, cfg.seed,
                                                    stacks[0], bsz))

        train, evals = _sweep_data(j_synthetic)
        cfg = _cfg(JTrainConfig, 12, learning_rate=1e-3)
        res = j_cv.run_seed_sweep(JFMRI(**FMRI), cfg, train, evals, 2,
                                  class_weights=CLASS_WEIGHTS, base_seed=11)
        out["sweep"] = dict(cfg=cfg, result=res,
                            variables=_initial_variables(
                                JFMRI(**FMRI), _fold_keys(11, 2),
                                [train, train], 12))
    return out


def test_regression_run_cv_matches_jax(jax_runs):
    run = jax_runs["reg"]
    res_j = run["result"]
    cfg = _port_cfg(run["cfg"])
    data = _reg_data(t_synthetic)
    splits = t_cv.fmri_kfold_splits(data, cfg, n_splits=3, stratify=False)
    res_t = t_cv.run_cv(TFMRI(task="regression", **FMRI, device="cpu"), cfg,
                        data, splits, task="regression", normalize="feature",
                        normalize_keys=FMRI_KEYS,
                        initial_variables=run["variables"])
    assert set(res_j.fold_metrics) == {"mse", "mae", "rmse", "r2"}
    _same_history_and_metrics(res_t, res_j)
    _close(res_t.test_probs, res_j.test_probs, "predictions")


def test_seed_sweep_matches_jax(jax_runs):
    run = jax_runs["sweep"]
    want = run["result"]
    train, evals = _sweep_data(t_synthetic)
    got = t_cv.run_seed_sweep(
        TFMRI(**FMRI, device="cpu"), _port_cfg(run["cfg"]), train, evals, 2,
        class_weights=CLASS_WEIGHTS, base_seed=11,
        initial_variables=run["variables"])
    _close(got["best_metric"], want["best_metric"], "best_metric")
    for k in ("mean", "std", "ci95"):
        _close(got[k], want[k], k)
    assert set(got["history"]) == set(want["history"])
    for k, v in want["history"].items():
        assert got["history"][k].shape == v.shape
        _close(got["history"][k], v, k)
    assert len(got["result"]) == 2


@pytest.mark.parametrize("confidence", [0.9, 0.95])
def test_confidence_interval_matches_jax(confidence):
    values = np.random.default_rng(6).normal(0.7, 0.1, 5)
    _close(t_stats.confidence_interval(values, confidence),
           j_stats.confidence_interval(values, confidence), "ci")
