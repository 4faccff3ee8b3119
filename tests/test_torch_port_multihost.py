"""``examples/multihost_cpu.py``'s multi-process flow on the port: one
spawned world of 4 gloo ranks as two hosts of two ranks
(``test_torch_port_workers.multihost_cases``, no JAX in the workers).

- Phase 1: a hybrid (ensemble 2 × data 2) mesh whose ensemble axis spans
  the hosts; each host loads only its ``process_fold_range`` block of the
  example's folds (distinct row ranges of one synthetic cohort, a narrow
  V4 at T=32, one epoch), trains it from the streams of ``fold_in(0, i)``
  and gathers the histories over the ensemble axis: every rank's equal the
  single process's unsharded run of all folds bit for bit.
- A three-axis (ensemble 2 × data 2 × model 1) mesh: ``psum`` over each
  pair of its axes (any order).
- Phase 2: a flat (ensemble 1 × data 4) mesh trains one fold with its
  batch sharded over ``data``: its history against the single process's
  run within the example's tolerances (rtol 2e-4, atol 2e-5; the gradient
  sums run in another order).
"""

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu_torch import make_fit_fn
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.core.rng import fold_in
from multimodal_eeg_fmri_tpu_torch.data.arrays import pad_rows, subset
from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
    synthetic_eeg_trimodal,
)
from multimodal_eeg_fmri_tpu_torch.parallel import spawn_local_world
from multimodal_eeg_fmri_tpu_torch.train.cv import fold_rngs, start_fold

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

WORLD = 4
KW = dict(hidden_dim=32, num_transformer_layers=1, num_heads=4, dropout=0.0)
CFG = dict(batch_size=4, num_epochs=1, learning_rate=1e-3,
           schedule="constant", selection="val", patience=100)
RTOL, ATOL = 2e-4, 2e-5


def _dp_fold():
    """The example's fold for the data-parallel phase: 16 training and 8
    validation rows."""
    raw = synthetic_eeg_trimodal(n_subjects=24, time_steps=32, seed=11)
    raw.pop("subject")
    return (pad_rows(subset(raw, np.arange(16)), 16),
            pad_rows(subset(raw, np.arange(16, 24)), 8))


@pytest.fixture(scope="module")
def ranks():
    out = spawn_local_world(workers.multihost_cases, WORLD, KW, CFG, {},
                            _dp_fold())
    assert not any(r[-1] for r in out)
    return out


def test_hosts_train_their_folds_and_gather_the_single_process_run(ranks):
    folds = workers.multihost_folds(2, 2)
    model = workers._narrow_v4(KW)
    fit = make_fit_fn(model, TrainConfig(**CFG), eval_names=("val",))
    want = []
    for i, (train, val) in enumerate(folds):
        rngs = fold_rngs(fold_in(0, i), "cpu")
        start_fold(model, rngs)
        want.append(fit(rngs.shuffle, train, {"val": val}).history)
    assert [r[0] for r in ranks] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    for r, (_, history, *_rest) in enumerate(ranks):
        assert history.keys() == want[0].keys()
        for k, v in history.items():
            assert torch.equal(v, torch.stack([w[k] for w in want])), (r, k)
    loss = torch.stack([w["train_loss"] for w in want]).ravel()
    assert len(set(loss.tolist())) > 1, "the folds' losses are equal"


def test_psum_over_two_axes_of_a_three_axis_mesh(ranks):
    # rank = 2·ensemble + data; the model axis holds one rank
    for rank, (*_, sums, _dp, _jax) in enumerate(ranks):
        e, d = divmod(rank, 2)
        assert sums["ensemble", "data"].item() == 6.0
        assert sums["data", "ensemble"].item() == 6.0
        assert sums["data", "model"].item() == 4.0 * e + 1.0
        assert sums["ensemble", "model"].item() == 2.0 + 2.0 * d


def test_data_parallel_fold_matches_the_single_process(ranks):
    train, val = _dp_fold()
    model = workers._narrow_v4(KW)
    start_fold(model, fold_rngs(7, "cpu"))
    want = make_fit_fn(model, TrainConfig(**{**CFG, "batch_size": 8}),
                       eval_names=("val",))(7, train, {"val": val}).history
    for r, rank in enumerate(ranks):
        got = rank[3]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {k}")
            assert torch.equal(got[k], ranks[0][3][k])
