"""The port's cross-validation runs against the JAX package's.

``run_cv`` of a narrow ``TriModalFusionNetV4`` (hidden 32, one layer, two
heads, dropout 0, T=32: the einsum route) over 24 synthetic subjects in 3
stratified-group folds, 2 epochs of weighted CE with a batch that holds the
whole padded fold, so that the shuffle only permutes rows inside it. Each
fold of the port starts from the flax variables the JAX package's ``fit``
initialises from that fold's key, so the two runs are comparable number for
number. The fusion gate's fixed dropout is off on both sides, as in
``test_torch_port_train.py``. The JAX run is module-scoped and shared by
every test of the file; ``test_torch_port_cv_fmri.py`` holds the
regression case and the seed sweep, with their own JAX runs.

Tolerances: fold metrics, histories, test probabilities and the stacked
best params within 1e-4 (whole fits, many f32 sums in another order), but
for the biases whose gradient is zero up to rounding, held to Adam's bound
as in ``test_fit_matches_jax``; cohorts, splits, fold arrays, best epochs,
test labels, weights and subjects exactly equal. The clinical report of
the port's run: finite, in range. The port's own rules: fold
seeds fixed by (seed, fold), each fold started afresh, the caller's
generator restored, ``aot_dir`` and a one-rank ``mesh_plan`` each equal
to the plain run,
``RngStream``'s replay by (seed, name, index) and ``seed_everything``.
"""

import contextlib
import dataclasses
import importlib

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from test_torch_port_train import _cancelled_biases

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import synthetic as j_synthetic
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.data import synthetic as t_synthetic
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4 as TTri
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet as TFMRI
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")
j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")

TRI = dict(hidden_dim=32, num_transformer_layers=1, num_heads=2, dropout=0.0)
FMRI = dict(hidden_dim=16, dropout=0.0)
EEG_KEYS = ("erp", "pw", "conn")
FMRI_KEYS = ("activation", "connectivity")
ATOL = 1e-4


def _eeg_data():
    return j_synthetic.synthetic_eeg_trimodal(n_subjects=24, time_steps=32,
                                              seed=3)


def _cfg(cls, batch_size, **kw):
    return cls(batch_size=batch_size, num_epochs=2, loss="weighted_ce",
               selection="val", seed=7, **kw)


def _padded_train_rows(data, splits, keys, normalize="scalar"):
    stack = j_cv.build_fold_arrays(data, splits, normalize, keys,
                                   weighted_classes=False)[0]
    return len(stack["label"][0])


def _initial_variables(fmod, keys, trains, bsz):
    """The flax variables that the JAX package's ``fit`` initialises from
    each key: split in three, ``init`` in train mode on the first batch of
    its training set (one compile for all of them)."""
    init = jax.jit(lambda r, d, x: fmod.init({"params": r, "dropout": d},
                                             **x, train=True))
    out = []
    for key, train in zip(keys, trains, strict=True):
        _, init_rng, drop_rng = jax.random.split(key, 3)
        inputs = j_fit.split_batch({k: v[:bsz] for k, v in train.items()})
        out.append(jax.tree.map(np.asarray, init(init_rng, drop_rng, inputs)))
    return out


def _fold_keys(seed, n):
    """The per-fold keys of the JAX package's ``run_cv`` and
    ``run_seed_sweep``."""
    return [jax.random.fold_in(jax.random.key(seed), i) for i in range(n)]


def _fold_variables(fmod, seed, train_stack, bsz):
    n = len(train_stack["label"])
    return _initial_variables(
        fmod, _fold_keys(seed, n),
        [{k: v[i] for k, v in train_stack.items()} for i in range(n)], bsz)


@contextlib.contextmanager
def flax_dropout_off():
    """flax ``Dropout`` as the identity: at dropout 0 only the fusion gate's
    fixed rate would draw, and the two frameworks cannot share its masks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        yield


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's run, and each fold's initial variables."""
    with flax_dropout_off():
        data = _eeg_data()
        cfg = _cfg(JTrainConfig, 1)
        splits = j_cv.eeg_kfold_splits(data, cfg, n_splits=3)
        bsz = _padded_train_rows(data, splits, EEG_KEYS)
        cfg = dataclasses.replace(cfg, batch_size=bsz)
        res = j_cv.run_cv(JTri(**TRI), cfg, data, splits,
                          normalize_keys=EEG_KEYS)
        stacks = j_cv.build_fold_arrays(data, splits, "scalar", EEG_KEYS)
        return dict(data=data, splits=splits, cfg=cfg, result=res,
                    stacks=stacks,
                    variables=_fold_variables(JTri(**TRI), cfg.seed,
                                              stacks[0], bsz))


def _port_cfg(cfg):
    return TrainConfig(**dataclasses.asdict(cfg))


def _tri():
    model = TTri(**TRI, device="cpu")
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    return model


@pytest.fixture(scope="module")
def port_eeg(jax_run):
    run = jax_run
    data = t_synthetic.synthetic_eeg_trimodal(n_subjects=24, time_steps=32,
                                              seed=3)
    splits = t_cv.eeg_kfold_splits(data, _port_cfg(run["cfg"]), n_splits=3)
    res = t_cv.run_cv(_tri(), _port_cfg(run["cfg"]), data, splits,
                      normalize_keys=EEG_KEYS,
                      initial_variables=run["variables"])
    return data, splits, res


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def _same_history_and_metrics(res_t, res_j):
    assert res_t.n_folds == res_j.n_folds
    assert set(res_t.fold_metrics) == set(res_j.fold_metrics)
    assert set(res_t.summary) == set(res_j.summary)
    for k, v in res_j.fold_metrics.items():
        _close(res_t.fold_metrics[k], v, k)
        _close(res_t.summary[k], res_j.summary[k], k)
    assert set(res_t.history) == set(res_j.history)
    for k, v in res_j.history.items():
        assert res_t.history[k].shape == v.shape
        _close(res_t.history[k], v, k)
    np.testing.assert_array_equal(res_t.best_epochs, res_j.best_epochs)


def test_cohorts_splits_and_fold_arrays_match_jax(jax_run, port_eeg):
    run = jax_run
    data, splits, _ = port_eeg
    assert data.keys() == run["data"].keys()
    for k, v in run["data"].items():
        np.testing.assert_array_equal(data[k], v)
    for sp, want in zip(splits, run["splits"], strict=True):
        for f in ("train", "val", "test"):
            np.testing.assert_array_equal(getattr(sp, f), getattr(want, f))
    got = t_cv.build_fold_arrays(data, splits, "scalar", EEG_KEYS)
    want = run["stacks"]
    assert len(got) == 4 and np.all(want[3] == 1)   # no fold padding
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        for name in (w if "val" in w else {"": w}):
            gs, ws = (g[name], w[name]) if name else (g, w)
            assert gs.keys() == ws.keys()
            for k in ws:
                assert gs[k].dtype == ws[k].dtype
                np.testing.assert_array_equal(gs[k], ws[k])
    np.testing.assert_array_equal(got[2], want[2])


def test_run_cv_matches_jax(jax_run, port_eeg):
    res_j = jax_run["result"]
    _, _, res_t = port_eeg
    _same_history_and_metrics(res_t, res_j)
    _close(res_t.test_probs, res_j.test_probs, "test_probs")
    for k in ("test_labels", "test_weight", "test_subjects"):
        got, want = getattr(res_t, k), getattr(res_j, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # stacked best params and statistics, fold by fold
    ref = TTri(**TRI, device="cpu")
    noisy = _cancelled_biases(ref)
    lr, steps = jax_run["cfg"].learning_rate, 2
    for i, variables in enumerate(jax_run["variables"]):
        want = load_flax_variables(
            ref, jax.tree.map(lambda x: np.asarray(x)[i], res_j.params),
            jax.tree.map(lambda x: np.asarray(x)[i],
                         res_j.batch_stats)).state_dict()
        initial = load_flax_variables(
            TTri(**TRI, device="cpu"), variables["params"],
            variables["batch_stats"]).state_dict()
        for k, got in {**res_t.params, **res_t.batch_stats}.items():
            if k.endswith("num_batches_tracked"):
                continue
            assert got.shape[0] == res_t.n_folds
            if k in noisy:
                # two Adam steps move such a bias by at most ~2·lr
                for p in (got[i], want[k]):
                    assert (p - initial[k]).abs().max().item() <= (
                        1.25 * steps * lr), k
            else:
                _close(got[i].detach(), want[k], f"fold {i} {k}")


def test_clinical_report_of_the_run(port_eeg):
    """The per-fold report of the port's run: finite, coverage and
    probabilities in [0, 1] (the report's functions are held to the JAX
    package's in ``test_torch_port_report.py``)."""
    from multimodal_eeg_fmri_tpu_torch.report.clinical import clinical_report

    report = clinical_report(port_eeg[2], device="cpu")
    assert set(report["per_fold"]) == {
        "ece", "brier", "opt_threshold", "opt_f1", "conformal_coverage",
        "conformal_set_size"}
    for k, v in report["per_fold"].items():
        assert v.shape == (3,) and np.all(np.isfinite(v)), k
        assert np.all((v >= 0) & (v <= (2 if k.endswith("size") else 1))), k
        assert report["summary"][k] == (v.mean(), v.std())


def test_loso_subject_votes_match_jax():
    """``subject_level_votes`` of a port LOSO run, and of the JAX package
    on the same outputs."""
    data = t_synthetic.synthetic_fmri(n_subjects=8, seed=8,
                                      with_regression=False)
    cfg = TrainConfig(batch_size=4, num_epochs=1, selection="train_loss")
    splits = t_cv.loso_splits(data, cfg)
    res = t_cv.run_cv(TFMRI(**FMRI, device="cpu"), cfg, data, splits,
                      normalize="feature", normalize_keys=FMRI_KEYS)
    assert res.n_folds == 8 and res.test_probs.shape == (8, 1, 2)
    fields = {f.name: getattr(res, f.name)
              for f in dataclasses.fields(j_cv.CVResult)}
    votes = t_cv.subject_level_votes(res)
    assert votes == j_cv.subject_level_votes(j_cv.CVResult(**fields))
    assert sorted(votes) == list(range(1, 9))


def test_fold_seeds_are_fixed_by_seed_and_fold():
    seeds = t_cv.fold_seeds(5, 3)
    assert seeds == t_cv.fold_seeds(torch.Generator().manual_seed(5), 3)
    assert len(set(seeds)) == 3
    assert t_cv.fold_seeds([1, torch.Generator().manual_seed(2)], 2) == [1, 2]
    with pytest.raises(ValueError, match="need 3"):
        t_cv.fold_seeds([1, 2], 3)
    a, b = (t_cv.fold_rngs(seeds[0], "cpu") for _ in range(2))
    assert torch.equal(torch.rand(4, generator=a.init),
                       torch.rand(4, generator=b.init))
    assert a.dropout_seed == b.dropout_seed


def test_run_cv_folds_start_fresh_and_restore_the_generators():
    """Each fold starts from its own initial weights, whatever ran before,
    and the caller's default generator is left as it was."""
    data = t_synthetic.synthetic_fmri(n_subjects=12, seed=9,
                                      with_regression=False)
    cfg = TrainConfig(batch_size=4, num_epochs=1, selection="train_loss",
                      seed=3)
    splits = t_cv.fmri_kfold_splits(data, cfg, n_splits=3)
    # equal folds: alone, the last fold pads to the size it has in the run
    assert len({(len(s.train), len(s.val), len(s.test)) for s in splits}) == 1
    model = TFMRI(**FMRI, device="cpu")
    torch.manual_seed(0)
    state = torch.get_rng_state()
    full = t_cv.run_cv(model, cfg, data, splits)
    assert torch.equal(torch.get_rng_state(), state)
    seeds = t_cv.fold_seeds(cfg.seed, 3)
    last = t_cv.run_cv(TFMRI(**FMRI, device="cpu"), cfg, data, splits[2:],
                       rng=seeds[2:])
    for k, v in last.params.items():
        assert v.device.type == "cpu"
        torch.testing.assert_close(v[0], full.params[k][2], atol=0, rtol=0)


@pytest.mark.parametrize("what", ["mesh_plan", "aot_dir"])
def test_unported_run_cv_options_raise(what, tmp_path):
    """Both options are ported, and neither changes the result: a plan of
    one rank (a layout-only mesh, no process group) and an ``aot_dir`` (its
    evaluation program bundled, then loaded by a second run) each give the
    plain run bit for bit (the sharded runs:
    ``test_torch_port_ensemble.py``; the bundles against JAX's:
    ``test_torch_port_aot.py``)."""
    from multimodal_eeg_fmri_tpu_torch.parallel import build_mesh

    data = t_synthetic.synthetic_fmri(n_subjects=8, with_regression=False)
    cfg = TrainConfig(batch_size=4, num_epochs=1, selection="train_loss")
    splits = t_cv.loso_splits(data, cfg)[:3]
    plain = t_cv.run_cv(TFMRI(**FMRI, device="cpu"), cfg, data, splits)
    if what == "aot_dir":
        for _ in range(2):   # a miss (exports), then a hit (loads)
            planned = t_cv.run_cv(TFMRI(**FMRI, device="cpu"), cfg, data,
                                  splits, aot_dir=str(tmp_path))
            assert len(list(tmp_path.glob("*.pt2"))) == 1
    else:
        planned = t_cv.run_cv(TFMRI(**FMRI, device="cpu"), cfg, data,
                              splits, mesh_plan=build_mesh(world_size=1))
    assert planned.n_folds == plain.n_folds == 3
    for k, v in plain.params.items():
        assert torch.equal(planned.params[k], v), k
    for k, v in plain.history.items():
        np.testing.assert_array_equal(planned.history[k], v, err_msg=k)
    np.testing.assert_array_equal(planned.test_probs, plain.test_probs)
    np.testing.assert_array_equal(planned.best_epochs, plain.best_epochs)


def test_rng_stream_replays_by_seed_name_and_index():
    """``RngStream``: each name's sequence depends only on (root seed,
    name, call index), whatever the interleaving; names and child scopes
    are independent; a generator root stands for its seed."""
    from multimodal_eeg_fmri_tpu.core.rng import _stable_hash as j_hash
    from multimodal_eeg_fmri_tpu_torch.core import rng as t_rng

    def draws(stream, names):
        return [torch.rand(3, generator=stream.next(n)) for n in names]

    a = draws(t_rng.RngStream(7), ["dropout", "aug", "dropout"])
    b = draws(t_rng.RngStream(torch.Generator().manual_seed(7)),
              ["aug", "dropout", "dropout"])
    torch.testing.assert_close(a[0], b[1], atol=0, rtol=0)
    torch.testing.assert_close(a[1], b[0], atol=0, rtol=0)
    torch.testing.assert_close(a[2], b[2], atol=0, rtol=0)
    assert not torch.equal(a[0], a[2]) and not torch.equal(a[0], a[1])
    child = t_rng.RngStream(7).fold("fold0")
    assert not torch.equal(draws(child, ["dropout"])[0], a[0])
    torch.testing.assert_close(
        draws(t_rng.RngStream(7).fold("fold0"), ["dropout"])[0],
        draws(t_rng.RngStream(t_rng.fold_in(7, t_rng._stable_hash("fold0"))),
              ["dropout"])[0], atol=0, rtol=0)
    for name in ("", "dropout", "fold0", "ünïcode"):
        assert t_rng._stable_hash(name) == j_hash(name)
    with pytest.raises(TypeError, match="int or a torch.Generator"):
        t_rng.RngStream(1.5)


def test_seed_everything_seeds_the_host_and_returns_the_root():
    import random

    from multimodal_eeg_fmri_tpu_torch.core.rng import seed_everything

    first = []
    for _ in range(2):
        root = seed_everything(11)
        first.append((random.random(), np.random.rand(), torch.rand(1).item(),
                      torch.rand(1, generator=root).item()))
    assert first[0] == first[1]
    assert root.initial_seed() == 11 and root.device.type == "cpu"
