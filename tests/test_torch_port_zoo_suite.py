"""The reference's four-model EEG comparison through the port's
``run_model_suite``, against the JAX package's.

``pipelines.run_eeg_experiment`` trains four models per fold: trimodal
(``TriModalFusionNetV4``), fusion (``SmartFusionNetV4``), pwonly and
erponly. Here they are narrow (hidden 32, one layer, two heads; the
baselines hidden 16), at dropout 0, over ``test_torch_port_cv.py``'s
cohort and settings: 24 synthetic subjects at T=32 in 3 stratified-group
folds, 2 epochs of weighted CE with a batch that holds the whole padded
fold. Each model's folds start in the port from the flax variables that
JAX's ``fit`` initialises from that fold's key: the port's suite runs once
per model, passing that model's ``initial_variables`` on to ``run_cv``.
``LearnedFusion``'s fixed gate dropout is off on both sides. The trimodal run is ``test_torch_port_cv.py``'s, so the two files
share XLA's compilation cache. Tolerances as there: fold metrics,
histories, test probabilities and best params within 1e-4, the biases
whose gradient is zero up to rounding held to Adam's bound.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
from test_torch_port_cv import (
    EEG_KEYS,
    TRI,
    _cfg,
    _eeg_data,
    _fold_variables,
    _padded_train_rows,
    _port_cfg,
    _same_history_and_metrics,
    flax_dropout_off,
)
from test_torch_port_train import _cancelled_biases
from test_torch_port_zoo import ATOL, CPU, _gate_dropout_off

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import eeg as j_eeg
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.data import synthetic as t_synthetic
from multimodal_eeg_fmri_tpu_torch.models import eeg as t_eeg

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")

SUITE = {
    "trimodal": (lambda: j_eeg.TriModalFusionNetV4(**TRI),
                 lambda: t_eeg.TriModalFusionNetV4(**TRI, **CPU)),
    "fusion": (lambda: j_eeg.SmartFusionNetV4(**TRI),
               lambda: t_eeg.SmartFusionNetV4(**TRI, **CPU)),
    "pwonly": (lambda: j_eeg.PWOnlyNet(16, dropout=0.0),
               lambda: t_eeg.PWOnlyNet(16, dropout=0.0, **CPU)),
    "erponly": (lambda: j_eeg.ERPOnlyNet(16, dropout=0.0),
                lambda: t_eeg.ERPOnlyNet(16, dropout=0.0, **CPU)),
}


@pytest.fixture(scope="module")
def suites():
    """JAX's ``run_model_suite`` of the four models over 3 stratified-group
    folds of 24 subjects (``test_torch_port_cv.py``'s cohort and settings),
    and the port's from each fold's flax variables."""
    with flax_dropout_off():
        data = _eeg_data()
        cfg = _cfg(JTrainConfig, 1)
        splits = j_cv.eeg_kfold_splits(data, cfg, n_splits=3)
        bsz = _padded_train_rows(data, splits, EEG_KEYS)
        cfg = dataclasses.replace(cfg, batch_size=bsz)
        res_j = j_cv.run_model_suite(
            {k: j() for k, (j, _) in SUITE.items()}, cfg, data, splits,
            normalize_keys=EEG_KEYS)
        train_stack = j_cv.build_fold_arrays(data, splits, "scalar",
                                             EEG_KEYS)[0]
        variables = {k: _fold_variables(j(), cfg.seed, train_stack, bsz)
                     for k, (j, _) in SUITE.items()}
    port_data = t_synthetic.synthetic_eeg_trimodal(n_subjects=24,
                                                   time_steps=32, seed=3)
    port_cfg = _port_cfg(cfg)
    port_splits = t_cv.eeg_kfold_splits(port_data, port_cfg, n_splits=3)
    res_t = {}
    for k, (_, t) in SUITE.items():
        res_t.update(t_cv.run_model_suite(
            {k: _gate_dropout_off(t())}, port_cfg, port_data, port_splits,
            normalize_keys=EEG_KEYS, initial_variables=variables[k]))
    return dict(jax=res_j, port=res_t, variables=variables, cfg=cfg)


@pytest.mark.parametrize("name", sorted(SUITE))
def test_run_model_suite_matches_jax(suites, name):
    """Fold metrics, histories, best epochs and test probabilities within
    1e-4; the best params of every fold within 1e-4, but the biases whose
    gradient is zero up to rounding, held to Adam's bound."""
    assert list(suites["port"]) == list(suites["jax"]) == list(SUITE)
    res_t, res_j = suites["port"][name], suites["jax"][name]
    _same_history_and_metrics(res_t, res_j)
    np.testing.assert_allclose(res_t.test_probs, res_j.test_probs, atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(res_t.test_labels, res_j.test_labels)
    ref = SUITE[name][1]()
    noisy = _cancelled_biases(ref)
    lr, steps = suites["cfg"].learning_rate, 2
    for i, v in enumerate(suites["variables"][name]):
        want = load_flax_variables(
            ref, jax.tree.map(lambda x: np.asarray(x)[i], res_j.params),
            jax.tree.map(lambda x: np.asarray(x)[i],
                         res_j.batch_stats)).state_dict()
        initial = load_flax_variables(SUITE[name][1](), v["params"],
                                      v["batch_stats"]).state_dict()
        for k, got in {**res_t.params, **res_t.batch_stats}.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k in noisy:
                for p in (got[i], want[k]):
                    assert (p - initial[k]).abs().max().item() <= (
                        1.25 * steps * lr), k
            else:
                np.testing.assert_allclose(got[i].detach().numpy(),
                                           want[k].numpy(), atol=ATOL,
                                           rtol=0, err_msg=f"fold {i} {k}")

