"""The port's pipeline parallelism (``parallel.pipeline``,
``PipelinedLongContextClassifier``) in a spawned world of 4 gloo ranks,
against the JAX package's.

- ``pipeline_apply`` of a residual GELU MLP stage over a 4-stage axis
  against the stages applied in sequence (JAX), forward at n_micro 4 and 8
  (atol/rtol 1e-5) and the gradient of sum(out²) in each stage (2e-4), as
  ``tests/test_pipeline_parallel.py`` holds JAX's; an indivisible batch
  raises.
- The classifier (hidden 32, 4 heads, patch 2, T = 64 over 4 channels, 8
  subjects in one batch, 2 epochs): the port's sequential twin against
  JAX's ``PipelinedLongContextClassifier(mesh=None)``, the port's 4-stage
  fit and its (stage 2 × seq 2) fit against JAX's pipelined fits on the
  same meshes, loss histories within rtol 2e-4 / atol 2e-5
  (``tests/test_long_context_training.py``'s limits), the shuffle the
  identity on both sides. Dropout: the 4-stage fit at dropout 0.1 equals
  the port's twin at 0.1 (the port's seed rule, not JAX's keys) and
  differs from dropout 0.
- ``seq_axis`` with dropout raises; JAX's stacked ``blocks`` load into the
  twin and into each stage rank and come back.
"""

import concurrent.futures
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import long_context as j_lc
from multimodal_eeg_fmri_tpu.models.layers import gelu as j_gelu
from multimodal_eeg_fmri_tpu_torch import load_flax_variables, make_fit_fn
from multimodal_eeg_fmri_tpu_torch.convert import flax_variables_from_module
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import (
    PipelinedLongContextClassifier,
)
from multimodal_eeg_fmri_tpu_torch.parallel import (
    Mesh,
    pipeline_apply,
    spawn_local_world,
)
from test_torch_port_moe import seeded_variables

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 devices")

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")

WORLD = 4
D = 16
KW = dict(hidden_dim=32, num_heads=4, patch=2)
T, C, N = 64, 4, 8
CFG = dict(batch_size=8, num_epochs=2, learning_rate=1e-3,
           schedule="constant", selection="train_loss", patience=100)
HISTORY_RTOL, HISTORY_ATOL = 2e-4, 2e-5
DROPOUT_SEED = 5

# name: (mesh shape, axis names, layers, JAX model kwargs)
FITS = {
    "pipe4": ((4,), ("stage",), 4, {}),
    "pipe2x2": ((2, 2), ("stage", "seq"), 2, dict(seq_axis="seq")),
}


def _stages():
    r = np.random.default_rng(0)
    return {"w": (r.normal(size=(WORLD, D, D)) / np.sqrt(D)).astype(
        np.float32),
            "b": (r.normal(size=(WORLD, D)) * 0.1).astype(np.float32)}


def _x():
    return np.random.default_rng(1).normal(size=(32, D)).astype(np.float32)


def _data():
    """``tests/test_long_context_training.py``'s task: class-dependent
    low-frequency drift."""
    r = np.random.default_rng(2)
    y = (np.arange(N) % 2).astype(np.int32)
    x = r.standard_normal((N, T, C)).astype(np.float32)
    drift = np.sin(np.linspace(0, 6 * np.pi, T))[None, :, None]
    x += (0.4 * (y * 2 - 1)[:, None, None] * drift).astype(np.float32)
    return {"erp": x, "label": y, "weight": np.ones(N, np.float32)}


@pytest.fixture(scope="module")
def variables():
    """Seeded flax variables of the 4- and 2-layer classifiers."""
    return {layers: jax.tree.map(np.asarray, seeded_variables(
        j_lc.PipelinedLongContextClassifier(num_layers=layers, **KW),
        kwargs=dict(erp=_data()["erp"][:8]), seed=layers))
        for layers in (4, 2)}


@pytest.fixture(scope="module")
def jax_runs(variables):
    """JAX's fits: the 4-layer twin, the 4-stage and the (2, 2) meshes;
    traced in turn, compiled in parallel threads."""
    data = jax.tree.map(jnp.asarray, _data())
    devices = np.asarray(jax.devices()[:WORLD])
    runs = {"twin4": (None, 4, {})}
    for name, (shape, names, layers, kw) in FITS.items():
        runs[name] = (JMesh(devices.reshape(shape), names), layers, kw)
    compiled = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
        for name, (mesh, layers, kw) in runs.items():
            fmod = j_lc.PipelinedLongContextClassifier(
                mesh=mesh, num_layers=layers, **KW, **kw)
            mp.setattr(fmod, "init", lambda *a, v=variables[layers], **k:
                       jax.tree.map(jnp.asarray, v))
            fn = jax.jit(j_fit.make_fit_fn(fmod, JTrainConfig(**CFG),
                                           eval_names=()))
            compiled[name] = fn.lower(jax.random.key(0), data, {}, None)
        with concurrent.futures.ThreadPoolExecutor(len(compiled)) as pool:
            done = dict(zip(compiled, pool.map(lambda c: c.compile(),
                                               compiled.values())))
        return {name: np.asarray(fn(jax.random.key(0), data, {}, None)
                                 .history["train_loss"])
                for name, fn in done.items()}


def _port_fit(layers, params, dropout=0.0):
    model = load_flax_variables(PipelinedLongContextClassifier(
        num_layers=layers, dropout=dropout, **KW, in_channels=C,
        device="cpu"), params)
    real = workers._identity_shuffle()
    try:
        torch.manual_seed(DROPOUT_SEED)
        res = make_fit_fn(model, TrainConfig(**CFG), eval_names=())(
            0, _data(), {})
    finally:
        torch.randperm = real
    return res.history["train_loss"].numpy()


@pytest.fixture(scope="module")
def port_runs(variables):
    """The world's pipeline cases and the fits on each mesh, beside the
    twin's fits in this process."""
    fits = {}
    for name, (shape, names, layers, kw) in FITS.items():
        fits[name] = (shape, names, dict(KW, in_channels=C, **kw),
                      variables[layers]["params"], _data(), DROPOUT_SEED)
    fits["pipe4_dropout"] = ((4,), ("stage",),
                             dict(KW, in_channels=C, dropout=0.1),
                             variables[4]["params"], _data(), DROPOUT_SEED)
    ranks = spawn_local_world(workers.pipeline_cases, WORLD, _stages(),
                              _x(), (4, 8), fits, CFG)
    assert not any(r[-1] for r in ranks)
    twin = {"twin4": _port_fit(4, variables[4]["params"]),
            "twin4_dropout": _port_fit(4, variables[4]["params"], 0.1)}
    return ranks, twin


def _sequential(params, x):
    for i in range(params["w"].shape[0]):
        x = j_gelu(x @ params["w"][i] + params["b"][i]) + x
    return x


def test_pipeline_apply_matches_sequential(port_runs):
    ranks, _ = port_runs
    params = jax.tree.map(jnp.asarray, _stages())
    x = jnp.asarray(_x())
    want = np.asarray(_sequential(params, x))
    grads = jax.grad(lambda p: jnp.sum(_sequential(p, x[:16]) ** 2))(params)
    for stage, ((applied, got_grads), *_) in enumerate(ranks):
        for n_micro, out in applied.items():
            np.testing.assert_allclose(out.numpy(), want, atol=1e-5,
                                       rtol=1e-5, err_msg=str(n_micro))
        for k, g in got_grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(grads[k][stage]),
                                       atol=2e-4, rtol=2e-4, err_msg=k)


def test_pipeline_rejects_indivisible_batch():
    mesh = Mesh(np.zeros(1, np.int64), ("stage",))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply({}, torch.zeros(10, D), lambda p, h: h, mesh,
                       n_micro=8)


def test_twin_matches_jax(jax_runs, port_runs):
    np.testing.assert_allclose(port_runs[1]["twin4"], jax_runs["twin4"],
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    assert jax_runs["twin4"][-1] < jax_runs["twin4"][0]


@pytest.mark.parametrize("name", sorted(FITS))
def test_pipelined_fit_matches_jax(jax_runs, port_runs, name):
    ranks, _ = port_runs
    for _, histories, _, _ in ranks:
        got = histories[name]["train_loss"].numpy()
        np.testing.assert_allclose(got, jax_runs[name], rtol=HISTORY_RTOL,
                                   atol=HISTORY_ATOL)
        assert np.array_equal(got, ranks[0][1][name]["train_loss"].numpy())


def test_pipelined_dropout_equals_the_twin(port_runs):
    ranks, twin = port_runs
    for _, histories, _, _ in ranks:
        got = histories["pipe4_dropout"]["train_loss"].numpy()
        np.testing.assert_allclose(got, twin["twin4_dropout"], rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(got - histories["pipe4"]["train_loss"].numpy()
                      ).max() > 1e-4


def test_seq_axis_with_dropout_raises():
    with pytest.raises(ValueError, match="dropout is not supported"):
        PipelinedLongContextClassifier(seq_axis="seq", dropout=0.1,
                                       device="cpu")


@pytest.mark.parametrize("name", sorted(FITS))
def test_full_state_dict_is_the_twins(port_runs, variables, name):
    layers = FITS[name][2]
    twin = load_flax_variables(PipelinedLongContextClassifier(
        num_layers=layers, **KW, in_channels=C, device="cpu"),
        variables[layers]["params"])
    for _, _, keys, _ in port_runs[0]:
        assert keys[name] == sorted(twin.state_dict())


def test_stacked_blocks_round_trip(variables):
    """JAX's stacked ``blocks`` into the twin (one block a layer) and back,
    and into each stage rank (its own layer); the twin's logits are JAX's
    twin's."""
    v = variables[4]
    twin = load_flax_variables(PipelinedLongContextClassifier(
        num_layers=4, **KW, in_channels=C, device="cpu"), v["params"])
    back = flax_variables_from_module(twin)["params"]
    jax.tree.map(np.testing.assert_array_equal, back, v["params"])
    for stage in range(4):
        mesh = Mesh(np.arange(4), ("stage",), rank=stage)
        rank = load_flax_variables(PipelinedLongContextClassifier(
            mesh=mesh, **KW, in_channels=C, device="cpu"), v["params"])
        for k, t in rank.state_dict().items():
            assert torch.equal(t, twin.state_dict()[k]), k
        assert {k.split(".")[1] for k in rank.state_dict()
                if k.startswith("blocks.")} == {str(stage)}
        with pytest.raises(ValueError, match="twin"):
            flax_variables_from_module(rank)
    erp = _data()["erp"][:4]
    fmod = j_lc.PipelinedLongContextClassifier(num_layers=4, **KW)
    want = jax.jit(lambda v, e: fmod.apply(v, erp=e).logits)(
        jax.tree.map(jnp.asarray, v), jnp.asarray(erp))
    with torch.no_grad():
        got = twin.eval()(erp=torch.from_numpy(erp)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
