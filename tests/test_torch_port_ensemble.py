"""The port's ensemble axis (``run_cv``, ``run_seed_sweep`` and ``run_hpo``
with a ``mesh_plan``, ``EnsemblePredictor(plan=...)``, ``parallel.mesh``'s
sharding helpers) against its own unsharded runs and the JAX package's.

- In a spawned world of 4 gloo ranks (``test_torch_port_workers.
  ensemble_cases``, no JAX in the workers), on an ensemble axis of 4 and on
  (ensemble 2 × data 2): ``run_cv`` of ``test_torch_port_cv.py``'s narrow
  V4 (hidden 32, one layer, two heads, T=32, 3 folds padded to 4), each
  real fold started from JAX's initial variables; a 4-seed
  ``run_seed_sweep`` and a 5-trial ``run_hpo`` over two architecture
  groups (each padded to the ensemble axis; the finalists' groups pad
  otherwise). Every rank's result equals the port's unsharded run bit for
  bit, ranks that share an ensemble coordinate included; ``run_cv`` also
  holds to JAX's ``run_cv`` on a (4, 1) mesh within
  ``test_torch_port_cv.py``'s tolerances (1e-4 for fits; splits, arrays and
  best epochs exactly). Seeds that do not divide the axis raise JAX's error.
- The planned ``EnsemblePredictor`` on (ensemble 2 × data 2), 4 members
  of ``test_torch_port_deploy.py``'s narrow V4 on the flash route: each
  rank folds its 2 members into one flash call per layer; the three
  reductions against JAX's planned predictor within 1e-5, votes exactly;
  a ``DynamicBatcher`` over it (rank 0 the front, one row a thread)
  against JAX's batcher over JAX's planned predictor alike, and bit for
  bit the port's direct planned call, every rank's counters the front's;
  the calibrated temperature within 1e-5 of JAX's, relative; the "not
  divisible" error; the export written by rank 0 serves what the unplanned
  predictor serves, bit for bit.
- ``build_fold_arrays`` with ``batch_multiple`` and ``fold_multiple``
  equal to JAX's, ``fold_mask`` included; each sharding helper's spec
  equal to JAX's ``PartitionSpec`` and its block equal to JAX's
  addressable shard at every coordinate of an (ensemble 4 × data 2)
  layout-only mesh.
- ``torch.func.vmap(torch.func.grad(...))`` through ``flash_attention``
  (K2 and K3's vmap rule) against ``jax.vmap(jax.grad(...))`` through the
  JAX package's in interpret mode within 1e-5, and against a loop over the
  members bit for bit.
"""

import concurrent.futures
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data.arrays import pad_rows, subset
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu.parallel import mesh as j_mesh
from multimodal_eeg_fmri_tpu.serving import DynamicBatcher as JBatcher
from multimodal_eeg_fmri_tpu.serving import EnsemblePredictor as JEnsemble
from multimodal_eeg_fmri_tpu.serving import stack_variable_trees as j_stack
from multimodal_eeg_fmri_tpu_torch import parallel as t_par
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.data import synthetic as t_synthetic
from multimodal_eeg_fmri_tpu_torch.serving import (
    EnsemblePredictor,
    load_artifact,
)
from test_torch_port_cv import (
    EEG_KEYS,
    TRI,
    _cfg,
    _eeg_data,
    _fold_variables,
    _padded_train_rows,
    _same_history_and_metrics,
    flax_dropout_off,
)
from test_torch_port_deploy import BATCH, DATA, port_model, seeded
from test_torch_port_train import _cancelled_biases

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

WORLD = 4
MESHES = [(4, 1), (2, 2)]           # (ensemble, data)
SERVE_MESH = (2, 2)
K = 4                               # ensemble members
ATOL = 1e-4                         # whole fits, against JAX
PROB_ATOL = 1e-5
N_SEEDS = 4
SWEEP_CFG = dict(batch_size=4, num_epochs=2, learning_rate=2e-3,
                 schedule="constant", selection="val", patience=100)
HPO_ARCH = dict(hidden_dim=(8, 16), num_transformer_layers=(1,),
                num_heads=(2,), dropout=(0.0,))
HPO_KW = dict(num_classes=2)


def _split(seed, n_train, n_val):
    data = t_synthetic.synthetic_eeg_trimodal(
        n_subjects=n_train + n_val, time_steps=32, separation=1.5, seed=seed)
    data.pop("subject")
    return (pad_rows(subset(data, np.arange(n_train)), n_train),
            pad_rows(subset(data, np.arange(n_train, n_train + n_val)),
                     n_val))


def _cv_setup():
    """The cohort and the JAX config (batch: the whole padded fold), as
    ``test_torch_port_cv.py`` has them."""
    data = _eeg_data()
    cfg = _cfg(JTrainConfig, 1)
    splits = j_cv.eeg_kfold_splits(data, cfg, n_splits=3)
    bsz = _padded_train_rows(data, splits, EEG_KEYS)
    return data, dataclasses.replace(cfg, batch_size=bsz)


def _initial_variables(data, cfg):
    """Each real fold's initial variables in JAX's run (no dropout mask
    reaches them, so flax's dropout stays as it is: the thread of
    ``_jax_refs`` patches it meanwhile)."""
    splits = j_cv.eeg_kfold_splits(data, cfg, n_splits=3)
    stacks = j_cv.build_fold_arrays(data, splits, "scalar", EEG_KEYS)
    return _fold_variables(JTri(**TRI), cfg.seed, stacks[0], cfg.batch_size)


def _labels(members):
    """The calibration labels: the unplanned ensemble's decisions with
    every third flipped."""
    probs = EnsemblePredictor.from_modules(
        [port_model(m) for m in members], batch_size=BATCH)(**DATA)
    y = probs.argmax(-1)
    y[::3] = 1 - y[::3]
    return y


def _jax_refs(data, cfg, members, labels):
    """JAX's run_cv on a (4, 1) mesh and its planned ensemble on (2, 2):
    the three reductions and the calibrated predictor."""
    with flax_dropout_off():
        cv = j_cv.run_cv(JTri(**TRI), cfg, data,
                         j_cv.eeg_kfold_splits(data, cfg, n_splits=3),
                         normalize_keys=EEG_KEYS,
                         mesh_plan=j_mesh.build_mesh(jax.devices()[:4],
                                                     ensemble=4, data=1))
    plan = j_mesh.build_mesh(jax.devices()[:4], ensemble=SERVE_MESH[0],
                             data=SERVE_MESH[1])
    params = j_stack([m["params"] for m in members])
    stats = j_stack([m["batch_stats"] for m in members])
    serve = {}
    for reduce in ("mean_probs", "vote", "none"):
        ens = JEnsemble(JTri(**TRI), params, stats, plan=plan,
                        batch_size=BATCH, reduce=reduce)
        serve[reduce] = ens(**DATA)
        if reduce != "none":
            serve["batcher", reduce] = _jax_batched(ens)
    cal = JEnsemble(JTri(**TRI), params, stats, plan=plan,
                    batch_size=BATCH).calibrated(DATA, labels)
    serve["temperature"] = cal.temperature
    serve["calibrated"] = cal(**DATA)
    return cv, serve


def _jax_batched(ens):
    """JAX's ``DynamicBatcher`` over ``ens``: each row of ``DATA`` from a
    thread of its own, as ``workers.serve_batched`` sends them."""
    out = {}
    n = len(DATA["erp"])
    with JBatcher(ens, max_delay_ms=20.0, timeout_s=workers.WAIT_S) as b:
        workers.run_threads(lambda i: out.__setitem__(i, b(**{
            k: v[i:i + 1] for k, v in DATA.items()})), n)
    return np.concatenate([out[i] for i in range(n)])


@pytest.fixture(scope="module")
def setup():
    data, cfg = _cv_setup()
    members = [seeded(k) for k in range(K)]
    return dict(data=data, cfg=cfg, members=members,
                labels=_labels(members), sweep=_split(2, 12, 4),
                hpo=_split(8, 16, 8))


@pytest.fixture(scope="module")
def jax_refs(setup):
    """``_jax_refs`` as a future, computed in a thread while the port's
    world runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_refs, setup["data"], setup["cfg"],
                          setup["members"], setup["labels"])


@pytest.fixture(scope="module")
def variables(setup, jax_refs):
    """The folds' initial variables, made while JAX's references run."""
    return _initial_variables(setup["data"], setup["cfg"])


@pytest.fixture(scope="module")
def world(setup, variables, tmp_path_factory):
    s = setup
    path = tmp_path_factory.mktemp("ensemble") / "planned.pt2"
    cv = (dict(TRI), s["data"], dataclasses.asdict(s["cfg"]), EEG_KEYS,
          variables)
    ranks = t_par.spawn_local_world(
        workers.ensemble_cases, WORLD, MESHES, cv, (dict(TRI), *s["sweep"], SWEEP_CFG, N_SEEDS),
        (HPO_KW, *s["hpo"], HPO_ARCH),
        (SERVE_MESH, dict(TRI), s["members"], DATA, s["labels"], BATCH,
         str(path)))
    assert not any(jax_loaded for _, jax_loaded in ranks)
    return [r for r, _ in ranks], path


@pytest.fixture(scope="module")
def unsharded(setup, variables):
    """The port's own unsharded runs of the world's cases."""
    s = setup
    cfg = TrainConfig(**dataclasses.asdict(s["cfg"]))
    cv = t_cv.run_cv(workers._narrow_v4(TRI), cfg, s["data"],
                     t_cv.eeg_kfold_splits(s["data"], cfg, n_splits=3),
                     normalize_keys=EEG_KEYS,
                     initial_variables=variables)
    train, val = s["sweep"]
    sweep = t_cv.run_seed_sweep(workers._narrow_v4(TRI),
                                TrainConfig(**SWEEP_CFG), train,
                                {"val": val}, N_SEEDS)
    hpo = workers.hpo_study(HPO_KW, *s["hpo"], workers.hpo_space(**HPO_ARCH))
    return dict(cv=cv, sweep=sweep, hpo=hpo)


def _equal(a, b, what):
    """Tensors, arrays, dicts, lists and scalars equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _cv_fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_run_cv_equals_unsharded(world, unsharded, shape):
    ranks, _ = world
    want = _cv_fields(unsharded["cv"])
    for r, rank in enumerate(ranks):
        res = rank["cv", shape]
        assert res.n_folds == 3 and res.test_probs.shape[0] == 3
        for k in res.params.values():
            assert k.shape[0] == 3
        _equal(_cv_fields(res), want, f"rank {r} on {shape}")


def test_sharded_run_cv_matches_jax(world, jax_refs):
    """Against JAX's sharded run: histories, best epochs, params and the
    test arrays; the fold metrics against the test metrics that JAX's
    sharded fit took of the same params at the best epoch. (JAX's final
    evaluation, ``jit(vmap(...))`` of params sharded along the vmapped
    axis, the partitioning its ``ensemble_vmap`` docstring calls unsafe,
    gives fold 1 an accuracy of 0.5 where its own history, its unsharded
    run and the port give 0.625; its test probabilities move by 1.3e-2.
    The port's test probabilities are held to JAX's unsharded run by
    ``test_torch_port_cv.py``, and this file holds them to the port's
    unsharded run bit for bit.)"""
    ranks, _ = world
    res_j = jax_refs.result()[0]
    res_t = ranks[0]["cv", (4, 1)]
    # JAX's params and histories keep the padded fold: the real ones
    hist = {k: np.asarray(v)[:3] for k, v in res_j.history.items()}
    at_best = {k: hist[f"test_{k}"][np.arange(3), res_j.best_epochs]
               for k in res_j.fold_metrics}
    _same_history_and_metrics(res_t, dataclasses.replace(
        res_j, history=hist, fold_metrics=at_best,
        summary={k: (float(np.mean(v)), float(np.std(v)))
                 for k, v in at_best.items()}))
    for k in ("test_labels", "test_weight", "test_subjects"):
        np.testing.assert_array_equal(getattr(res_t, k), getattr(res_j, k))
    from multimodal_eeg_fmri_tpu_torch import load_flax_variables

    noisy = _cancelled_biases(workers._narrow_v4(TRI))
    for i in range(3):
        want = load_flax_variables(
            workers._narrow_v4(TRI),
            jax.tree.map(lambda x: np.asarray(x)[i], res_j.params),
            jax.tree.map(lambda x: np.asarray(x)[i],
                         res_j.batch_stats)).state_dict()
        for k, got in {**res_t.params, **res_t.batch_stats}.items():
            if k in noisy or k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[i].numpy(), want[k].numpy(),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"fold {i} {k}")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_seed_sweep_and_hpo_equal_unsharded(world, unsharded,
                                                    shape):
    ranks, _ = world
    for r, rank in enumerate(ranks):
        got, want = rank["sweep", shape], unsharded["sweep"]
        _equal({k: got[k] for k in ("best_metric", "history", "mean", "std",
                                    "ci95")},
               {k: want[k] for k in ("best_metric", "history", "mean", "std",
                                     "ci95")}, f"rank {r} sweep")
        assert len(got["result"]) == N_SEEDS
        for i, (a, b) in enumerate(zip(got["result"], want["result"])):
            _equal(a._asdict(), b._asdict(), f"rank {r} seed {i}")
        assert rank["sweep_error", shape] == (
            f"the ensemble axis ({shape[0]}) must divide n_seeds="
            f"{N_SEEDS + 1}")
        got, want = rank["hpo", shape], unsharded["hpo"]
        _equal(dataclasses.asdict(got), dataclasses.asdict(want),
               f"rank {r} hpo")
    # the finalists come from both architecture groups or one
    assert len(unsharded["hpo"].rung_scores[1]) == 2


def test_seed_sweep_error_is_jax_s():
    from multimodal_eeg_fmri_tpu.models import TriModalFusionNetV4Lite

    train, val = _split(2, 12, 4)
    plan = j_mesh.build_mesh(jax.devices()[:4], ensemble=4, data=1)
    with pytest.raises(ValueError) as err:
        j_cv.run_seed_sweep(TriModalFusionNetV4Lite(hidden_dim=16),
                            JTrainConfig(), train, {"val": val}, 5,
                            mesh_plan=plan)
    assert str(err.value) == "the ensemble axis (4) must divide n_seeds=5"


@pytest.mark.parametrize("reduce", ["mean_probs", "vote", "none"])
def test_planned_ensemble_matches_jax(world, jax_refs, reduce):
    ranks, _ = world
    want = jax_refs.result()[1][reduce]
    for r, rank in enumerate(ranks):
        got = rank["serve"][reduce]
        assert got.shape == want.shape
        if reduce == "vote":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
        _equal(got, ranks[0]["serve"][reduce], f"rank {r}")
        # each rank's 2 members in one flash call a layer and batch
        calls = rank["serve"]["calls", reduce]
        assert len(calls) == 3 * -(-len(DATA["erp"]) // BATCH)
        assert {c[0] for c in calls} == {2 * BATCH}


@pytest.mark.parametrize("reduce", ["mean_probs", "vote"])
def test_planned_batcher_matches_jax_and_the_direct_call(world, jax_refs,
                                                         reduce):
    """A ``DynamicBatcher`` over the planned predictor on every rank, rank
    0 taking each row of ``DATA`` from its own thread: its rows against
    JAX's ``DynamicBatcher`` over JAX's planned predictor within 1e-5
    (votes exactly), and bit for bit the port's direct planned call on the
    same rows; every rank made the front's calls (its counters) and
    stopped at the front's ``close()``."""
    ranks, _ = world
    want = jax_refs.result()[1]["batcher", reduce]
    got, batches, rows, alive = ranks[0]["serve"]["batcher", reduce]
    assert got.shape == want.shape
    if reduce == "vote":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got, ranks[0]["serve"][reduce])
    assert rows == len(DATA["erp"]) and 1 <= batches <= rows
    for r, rank in enumerate(ranks):
        follower = rank["serve"]["batcher", reduce]
        assert (r == 0) == (follower[0] is not None)
        assert follower[1:] == (batches, rows, False), r


def test_planned_ensemble_calibration_error_and_export(world, jax_refs,
                                                       setup):
    """The planned calibration fits the unplanned predictor's temperature
    (all K members' logits, gathered) and serves JAX's calibrated
    probabilities within 1e-5; T itself within 1e-4 of JAX's, relative:
    these random members' probabilities all lie within 0.03 of 0.5, so the
    NLL is flat at its minimum (T ≈ 0.094) and the unplanned predictors of
    the two packages already differ by 2.0e-5 there."""
    ranks, path = world
    want = jax_refs.result()[1]
    models = [port_model(m) for m in setup["members"]]
    unplanned = EnsemblePredictor.from_modules(models, batch_size=BATCH)
    t = unplanned.calibrated(DATA, setup["labels"]).temperature
    for rank in ranks:
        served = rank["serve"]
        assert served["temperature"] == t
        assert abs(served["temperature"] - want["temperature"]) <= (
            1e-4 * want["temperature"])
        np.testing.assert_allclose(served["calibrated"], want["calibrated"],
                                   atol=PROB_ATOL, rtol=0)
        assert served["error"] == ("3 members not divisible by the mesh's "
                                   "ensemble axis (2)")
    assert isinstance(ranks[0]["serve"]["export"], bytes)
    assert all(r["serve"]["export"] is None for r in ranks[1:])
    assert path.read_bytes() == ranks[0]["serve"]["export"]
    rows = {k: v[:BATCH] for k, v in DATA.items()}
    np.testing.assert_array_equal(load_artifact(path)(**rows),
                                  unplanned(**rows))


def test_build_fold_arrays_pads_as_jax():
    data = _eeg_data()
    splits = j_cv.eeg_kfold_splits(data, _cfg(JTrainConfig, 1), n_splits=3)
    for batch_multiple, fold_multiple in ((1, 4), (8, 2), (5, 1)):
        got = t_cv.build_fold_arrays(data, splits, "scalar", EEG_KEYS,
                                     batch_multiple=batch_multiple,
                                     fold_multiple=fold_multiple)
        want = j_cv.build_fold_arrays(data, splits, "scalar", EEG_KEYS,
                                      batch_multiple=batch_multiple,
                                      fold_multiple=fold_multiple)
        assert len(got) == len(want) == 4
        _equal(got[0], want[0], "train")
        _equal(got[1], want[1], "evals")
        _equal(got[2], want[2], "class weights")
        _equal(got[3], want[3], "fold mask")
        assert got[3].dtype == want[3].dtype
        assert len(got[3]) % fold_multiple == 0
        assert got[0]["label"].shape[1] % batch_multiple == 0


def test_sharding_helpers_equal_jax():
    jplan = j_mesh.build_mesh(jax.devices()[:8], ensemble=4, data=2)
    r = np.random.default_rng(0)
    tree = {"x": r.standard_normal((8, 6, 3)).astype(np.float32),
            "y": np.arange(8 * 5).reshape(8, 5)}
    for ndim in (1, 2, 3):
        plan = t_par.build_mesh(ensemble=4, data=2, world_size=8, rank=0)
        assert t_par.replicated(plan) == tuple(j_mesh.replicated(jplan).spec)
        for t_fn, j_fn in ((t_par.batch_sharding, j_mesh.batch_sharding),
                           (t_par.ensemble_sharding,
                            j_mesh.ensemble_sharding)):
            assert t_fn(plan, ndim) == tuple(j_fn(jplan, ndim).spec)
        if ndim >= 2:
            assert t_par.ensemble_batch_sharding(plan, ndim) == tuple(
                j_mesh.ensemble_batch_sharding(jplan, ndim).spec)
    for t_fn, j_fn in ((t_par.shard_batch, j_mesh.shard_batch),
                       (t_par.shard_ensemble_tree,
                        j_mesh.shard_ensemble_tree)):
        placed = j_fn(jplan, tree)
        for rank in range(8):
            plan = t_par.build_mesh(ensemble=4, data=2, world_size=8,
                                    rank=rank)
            device = jplan.mesh.devices.flat[rank]
            got = t_fn(plan, tree)
            for k, arr in placed.items():
                (shard,) = [s for s in arr.addressable_shards
                            if s.device == device]
                np.testing.assert_array_equal(got[k], np.asarray(shard.data),
                                              err_msg=f"{k} rank {rank}")


def test_vmap_of_grad_through_flash_matches_jax():
    r = np.random.default_rng(4)
    q, k, v, w = (r.standard_normal((3, 2, 2, 40, 16)).astype(np.float32)
                  for _ in range(4))

    def j_loss(q, k, v, w):
        o, lse = jax_attn.flash_attention_lse(q, k, v, interpret=True)
        return (o * w).sum() + lse.sum()

    def t_loss(q, k, v, w):
        o, lse = port_attn.flash_attention_lse(q, k, v)
        return (o * w).sum() + lse.sum()

    want = jax.vmap(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v, w)))
    t_grad = torch.func.grad(t_loss, argnums=(0, 1, 2))
    args = [torch.from_numpy(x) for x in (q, k, v, w)]
    got = torch.func.vmap(t_grad)(*args)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    for i in range(3):
        for g, one in zip(got, t_grad(*(a[i] for a in args))):
            assert torch.equal(g[i], one)
