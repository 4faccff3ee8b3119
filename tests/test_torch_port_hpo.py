"""The port's HPO study against the JAX package's.

``sample_trials`` is the same numpy code on both sides: equal trials for
``DEFAULT_SPACE`` and two other spaces over several seeds and trial counts,
and ``DEFAULT_SPACE``'s head dims at 16 trials (fault C9: half of them lie
between the flash kernels' instances).

``run_hpo`` number for number: a space of one architecture group
(``TriModalFusionNetV4`` at hidden 16, one layer, two heads, dropout 0,
T=32: the einsum route) with lr and wd drawn, 4 trials, 2 proxy and 2 full
epochs, ``top_fraction=0.5``, over 16 training rows in one batch (so that
each framework's shuffle only permutes rows inside it). Each trial of the
port starts from the flax variables the JAX package's vmapped ``fit``
initialises from that trial's in-group key ``fold_in(key(seed), j)``
(``_start_trial`` patched, as ``test_torch_port_cv.py`` hands ``run_cv``
its folds' variables); the fusion gate's fixed dropout is off on both
sides. Rung scores and best score within 1e-4, the finalists equal where
the top-k margin exceeds that, the best params equal.
``test_torch_port_hpo_gnn.py`` holds the GNN family's run.
"""

import dataclasses
import importlib
import math

import jax
import numpy as np
import pytest
import torch
from test_torch_port_cv import _initial_variables, flax_dropout_off

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import synthetic as j_synthetic
from multimodal_eeg_fmri_tpu.data.arrays import pad_rows, subset
from multimodal_eeg_fmri_tpu.data.arrays import balanced_class_weights
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.core.rng import fold_in
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.train.cv import fold_rngs, start_fold

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_hpo = importlib.import_module("multimodal_eeg_fmri_tpu.train.hpo")
t_hpo = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.hpo")

ATOL = 1e-4
SEED = 3


def _spaces(mod):
    return {
        "default": mod.DEFAULT_SPACE,
        "mixed": {"lr": mod.LogUniform(1e-4, 1e-1),
                  "momentum": mod.Uniform(0.5, 0.99),
                  "act": mod.Choice(("gelu", "relu", "silu")),
                  "width": mod.Choice((8, 16, 32, 64, 128))},
        "uniform": {"a": mod.Uniform(-2.0, 3.0), "b": mod.Uniform(0.0, 1.0),
                    "c": mod.LogUniform(1e-3, 1e3)},
    }


@pytest.mark.parametrize("space", ["default", "mixed", "uniform"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_trials", [1, 5, 16])
def test_sample_trials_equal_jax(space, seed, n_trials):
    got = t_hpo.sample_trials(_spaces(t_hpo)[space], n_trials, seed)
    want = j_hpo.sample_trials(_spaces(j_hpo)[space], n_trials, seed)
    assert got == want


def test_default_space_head_dims():
    """DEFAULT_SPACE at 16 trials, seed 0: 8 of the trials' head dims
    (hidden_dim / num_heads) are not a kernel instance's."""
    trials = t_hpo.sample_trials(t_hpo.DEFAULT_SPACE, 16, seed=0)
    dims = [t["hidden_dim"] // t["num_heads"] for t in trials]
    counts = {d: dims.count(d) for d in sorted(set(dims))}
    assert counts == {8: 3, 12: 1, 16: 3, 24: 1, 32: 4, 48: 3, 64: 1}
    assert sum(d not in (16, 32, 64, 128) for d in dims) == 8


def test_run_hpo_unported_options():
    """``mesh_plan`` is ported: a plan of one rank (a layout-only mesh, no
    process group) gives the unplanned study (the sharded studies:
    ``test_torch_port_ensemble.py``); ``run_hpo_optuna`` raises without
    optuna."""
    from multimodal_eeg_fmri_tpu_torch.parallel import build_mesh

    train, val = _data(8, 8, 4)
    make = dict(conn_shape=(459,), device="cpu")
    space = _space(t_hpo, hidden_dim=8, num_transformer_layers=1,
                   num_heads=2, dropout=0.0)
    runs = [t_hpo.run_hpo(
        lambda **kw: t_hpo.build_trimodal(False, **make, **kw),
        _cfg(TrainConfig, 8), train, val, space=space, n_trials=3,
        proxy_epochs=1, full_epochs=1, top_fraction=0.5, seed=SEED,
        mesh_plan=plan) for plan in (None, build_mesh(world_size=1))]
    for a, b in zip(*(r.rung_scores for r in runs), strict=True):
        np.testing.assert_array_equal(a, b)
    assert runs[0].best_params == runs[1].best_params
    try:
        import optuna  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="optuna is not installed"):
            t_hpo.run_hpo_optuna(None, TrainConfig(), {}, {})


def test_build_trimodal_families():
    v4 = t_hpo.build_trimodal(False, device="cpu", conn_shape=(459,),
                              hidden_dim=16, num_heads=2)
    gnn = t_hpo.build_trimodal(True, device="cpu", conn_shape=(6, 6, 2),
                               hidden_dim=16, num_heads=2)
    assert type(v4).__name__ == "TriModalFusionNetV4"
    assert type(gnn).__name__ == "TriModalFusionNetGNN"
    assert v4.conn_encoder.mlp.dense_0.in_features == 459
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_hpo.build_trimodal(False)


# --- run_hpo number for number -----------------------------------------------

ARCH = dict(hidden_dim=16, num_transformer_layers=1, num_heads=2,
            dropout=0.0)


def _space(mod, **arch):
    return {"lr": mod.LogUniform(1e-3, 3e-2), "wd": mod.LogUniform(1e-6, 1e-2),
            **{k: mod.Choice((v,)) for k, v in arch.items()}}


def _data(seed, n_train, n_val, **kw):
    data = j_synthetic.synthetic_eeg_trimodal(
        n_subjects=n_train + n_val, time_steps=32, separation=1.0, seed=seed,
        **kw)
    data.pop("subject")
    return (pad_rows(subset(data, np.arange(n_train)), n_train),
            pad_rows(subset(data, np.arange(n_train, n_train + n_val)),
                     n_val))


def _cfg(cls, batch):
    return cls(batch_size=batch, num_epochs=2, schedule="constant",
               patience=100, seed=SEED)


def jax_study(make_model, arch, train, val, n_trials, top_fraction):
    """The JAX package's ``run_hpo`` and each in-group position's initial
    variables (positions 0..n_trials-1)."""
    with flax_dropout_off():
        cw = balanced_class_weights(train["label"])
        res = j_hpo.run_hpo(make_model, _cfg(JTrainConfig, len(train["label"])),
                            train, val, space=_space(j_hpo, **arch),
                            n_trials=n_trials, proxy_epochs=2,
                            full_epochs=2, top_fraction=top_fraction,
                            seed=SEED, class_weights=cw)
        keys = [jax.random.fold_in(jax.random.key(SEED), j)
                for j in range(n_trials)]
        variables = _initial_variables(make_model(**arch), keys,
                                       [train] * n_trials,
                                       len(train["label"]))
    return dict(result=res, variables=variables, cw=cw)


def port_study(make_model, arch, train, val, n_trials, top_fraction, jax_run,
               monkeypatch):
    """The port's ``run_hpo`` with each trial started from JAX's variables
    for its in-group position."""

    def start_trial(model, arch_kwargs, j, seed):
        assert arch_kwargs == arch and seed == SEED
        rngs = fold_rngs(fold_in(seed, j), next(model.parameters()).device)
        start_fold(model, rngs, jax_run["variables"][j])
        return rngs

    monkeypatch.setattr(t_hpo, "_start_trial", start_trial)

    def build(**kw):
        model = make_model(**kw)
        for m in model.modules():
            if isinstance(m, LearnedFusion):
                m.gate_dropout = 0.0
        return model

    return t_hpo.run_hpo(build, _cfg(TrainConfig, len(train["label"])),
                         train, val, space=_space(t_hpo, **arch),
                         n_trials=n_trials, proxy_epochs=2, full_epochs=2,
                         top_fraction=top_fraction, seed=SEED,
                         class_weights=jax_run["cw"])


def assert_studies_agree(got, want, n_trials, top_fraction):
    """Rung scores and the best score within ATOL, the trials' draws equal,
    the finalists equal where the top-k margin exceeds ATOL, the best
    params equal."""
    s1 = np.asarray(want.rung_scores[0])
    np.testing.assert_allclose(got.rung_scores[0], s1, atol=ATOL, rtol=0)
    for a, b in zip(got.trials, want.trials, strict=True):
        assert {k: v for k, v in a.items() if k != "score"} == {
            k: v for k, v in b.items() if k != "score"}
        assert math.isclose(a["score"], b["score"], abs_tol=ATOL)
    k = max(1, int(round(n_trials * top_fraction)))
    ranked = np.sort(s1)[::-1]
    if k < n_trials and ranked[k - 1] - ranked[k] > ATOL:
        np.testing.assert_allclose(got.rung_scores[1], want.rung_scores[1],
                                   atol=ATOL, rtol=0)
        assert got.best_params == want.best_params
        assert math.isclose(got.best_score, want.best_score, abs_tol=ATOL)
    return ranked


@pytest.fixture(scope="module")
def v4_study():
    from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4

    train, val = _data(8, 16, 8)
    return dict(train=train, val=val,
                jax=jax_study(lambda **kw: TriModalFusionNetV4(**kw), ARCH,
                              train, val, 4, 0.5))


def test_run_hpo_matches_jax(v4_study, monkeypatch):
    jax_run = v4_study["jax"]
    got = port_study(
        lambda **kw: t_hpo.build_trimodal(False, device="cpu",
                                          conn_shape=(459,), **kw),
        ARCH, v4_study["train"], v4_study["val"], 4, 0.5, jax_run,
        monkeypatch)
    want = jax_run["result"]
    ranked = assert_studies_agree(got, want, 4, 0.5)
    assert ranked[1] - ranked[2] > ATOL, "the finalists were a near tie"
    assert set(got.best_params) == set(_space(t_hpo, **ARCH))


def test_trial_seeds_are_in_group(v4_study, monkeypatch):
    """Trial j of a group takes fold_in(seed, j): the rung-2 group restarts
    at position 0, as the JAX package's vmapped keys do."""
    seen = []
    orig = t_hpo._start_trial

    def spy(model, arch_kwargs, j, seed):
        seen.append(j)
        return orig(model, arch_kwargs, j, seed)

    monkeypatch.setattr(t_hpo, "_start_trial", spy)
    arch = dict(ARCH, hidden_dim=8)
    t_hpo.run_hpo(
        lambda **kw: t_hpo.build_trimodal(False, device="cpu",
                                          conn_shape=(459,), **kw),
        dataclasses.replace(_cfg(TrainConfig, 16), num_epochs=1),
        v4_study["train"], v4_study["val"], space=_space(t_hpo, **arch),
        n_trials=3, proxy_epochs=1, full_epochs=1, top_fraction=0.7)
    assert seen == [0, 1, 2, 0, 1]
