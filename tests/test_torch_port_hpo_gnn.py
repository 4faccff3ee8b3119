"""The port's ``run_hpo`` on the GNN family against the JAX package's:
``build_trimodal(use_gnn=True)`` (``TriModalFusionNetGNN``) on matrix
connectivity (B, 6, 6, 2), one trial of hidden 16, one layer, two heads,
dropout 0, T=32, 2 proxy and 2 full epochs, started from the flax variables
the JAX package's ``fit`` initialises from the trial's key. Scores within
1e-4, the best params equal. Kept apart from ``test_torch_port_hpo.py`` so
that each file's JAX compiles run on a worker of their own.
"""

import importlib
import math

import torch
from test_torch_port_hpo import (
    ATOL,
    _data,
    assert_studies_agree,
    jax_study,
    port_study,
)

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_hpo = importlib.import_module("multimodal_eeg_fmri_tpu.train.hpo")
t_hpo = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.hpo")

GNN_ARCH = dict(use_gnn=True, hidden_dim=16, num_transformer_layers=1,
                num_heads=2, dropout=0.0)


def test_run_hpo_gnn_family_matches_jax(monkeypatch):
    train, val = _data(9, 16, 8, conn_as_matrix=True, n_nodes=6, n_metrics=2)
    assert train["conn"].shape == (16, 6, 6, 2)
    jax_run = jax_study(j_hpo.build_trimodal, GNN_ARCH, train, val, 1, 0.5)
    got = port_study(
        lambda **kw: t_hpo.build_trimodal(device="cpu", conn_shape=(6, 6, 2),
                                          **kw),
        GNN_ARCH, train, val, 1, 0.5, jax_run, monkeypatch)
    want = jax_run["result"]
    assert_studies_agree(got, want, 1, 0.5)
    # one trial: it is the finalist
    assert got.best_params == want.best_params
    assert got.best_params["use_gnn"] is True
    assert math.isclose(got.best_score, want.best_score, abs_tol=ATOL)
    assert math.isclose(got.rung_scores[1][0], float(want.rung_scores[1][0]),
                        abs_tol=ATOL)
