"""The port's tensor parallelism and FSDP (``parallel.tensor``,
``parallel.fsdp``) against the JAX package's.

- ``tp_param_specs`` and ``fsdp_param_specs`` (alone and extending the TP
  specs) equal JAX's on ``TriModalFusionNetV4`` and ``MultimodalEndToEnd``,
  JAX's ``PartitionSpec``s carried to the port's tensors
  (``parallel.layout.flax_layout``, whose flax shapes are checked against
  JAX's leaves).
- In a spawned world of 4 gloo ranks, the narrow V4
  (``tests/test_fsdp.py``'s model and data: hidden 32, one layer, 4
  heads, 16 training and 8 validation subjects) under TP on (data 2 ×
  model 2), FSDP on data 4 and FSDP×TP on (data 2 × model 2), against
  JAX's unsharded model from the same variables: the first step's
  gradient, reduced and gathered, per tensor within 1e-4 of its largest
  entry and its global norm within 1e-4 relative; two epochs of one batch
  (the second epoch's loss follows the first update) against JAX's fit,
  train loss, val F1 and accuracy within 1e-4 (``tests/test_fsdp.py``'s
  limits). AdamW's state comes out at 1/4 a rank for every FSDP-sharded
  parameter.
- An FSDP ``fit_resumable`` with ``grad_accum=2``, EMA and asynchronous
  saves that crashes in its second chunk and resumes: its history equals
  the uninterrupted unsharded run's (rtol 2e-4, atol 2e-5).
"""

import concurrent.futures
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data.arrays import subset
from multimodal_eeg_fmri_tpu.data.synthetic import synthetic_eeg_trimodal
from multimodal_eeg_fmri_tpu.models import eeg as j_eeg
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu.ops.losses import make_loss_fn
from multimodal_eeg_fmri_tpu.parallel import fsdp as j_fsdp
from multimodal_eeg_fmri_tpu.parallel import tensor as j_tensor
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import (
    MultimodalEndToEnd,
    TriModalFusionNetV4,
)
from multimodal_eeg_fmri_tpu_torch.parallel import (
    fsdp_param_specs,
    spawn_local_world,
    tp_param_specs,
)
from multimodal_eeg_fmri_tpu_torch.parallel.layout import flax_layout
from multimodal_eeg_fmri_tpu_torch.train.resilient import fit_resumable
from test_torch_port_moe import seeded_variables
from test_torch_port_train import _batch, _cancelled_biases

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")

WORLD = 4
V4 = dict(hidden_dim=32, num_transformer_layers=1, num_heads=4, dropout=0.0)
CFG1 = dict(batch_size=16, num_epochs=2, learning_rate=3e-3,
            schedule="constant", selection="val", patience=100)
RESUME = dict(CFG1, num_epochs=2, grad_accum=2, ema_decay=0.9)
KEYS = ("train_loss", "val_f1", "val_accuracy")

# name: (layout, mesh shape, axis names)
FITS = {
    "tp": ("tp", (2, 2), ("data", "model")),
    "fsdp": ("fsdp", (4,), ("data",)),
    "fsdp_tp": ("fsdp_tp", (2, 2), ("data", "model")),
}


def _no_dropout(mp):
    import flax.linen as fnn

    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)


def _data():
    data = synthetic_eeg_trimodal(n_subjects=24, time_steps=32,
                                  separation=2.0, seed=5)
    data.pop("subject")
    data = {k: np.asarray(v) for k, v in data.items()}
    return subset(data, np.arange(16)), subset(data, np.arange(16, 24))


@pytest.fixture(scope="module")
def variables():
    train, _ = _data()
    inputs = {k: train[k][:4] for k in ("erp", "pw", "conn")}
    return jax.tree.map(np.asarray, seeded_variables(
        j_eeg.TriModalFusionNetV4(**V4), kwargs=inputs, seed=1))


def jax_step_grads(fmod, variables, train, batch_size):
    """JAX's gradient of ``fit``'s first step (weighted CE without class
    weights, plus the aux losses) on the first ``batch_size`` rows of
    ``train``, dropout off, from ``variables``."""
    batch = {k: jnp.asarray(v[:batch_size]) for k, v in train.items()}
    loss_fn = make_loss_fn("weighted_ce")
    stats = variables.get("batch_stats")

    def loss(params):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        out, mut = fmod.apply(v, **j_fit.split_batch(batch), train=True,
                              rngs={"dropout": jax.random.key(0)},
                              mutable=["batch_stats", "losses"])
        aux = sum(jnp.sum(a) for a in
                  jax.tree_util.tree_leaves(mut.get("losses", {})))
        return loss_fn(out.logits, batch["label"], None,
                       batch.get("weight")) + aux

    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        grads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray,
                                                     variables["params"]))
    return jax.tree.map(np.asarray, grads)


def assert_grads_match_jax(model, got, norm, want):
    """``got`` (full tensors by the port's names) within 1e-4 of each
    tensor's largest entry of ``want`` (JAX's gradient tree), and ``norm``
    within 1e-4 of its global norm; ``model``: an unsharded port model of
    the same layout. A bias whose gradient is zero up to rounding
    (``_cancelled_biases``) is held within 1e-4 of the whole gradient's
    largest entry."""
    from flax import traverse_util

    flat = traverse_util.flatten_dict(want)
    layout = flax_layout(model)
    ports = {n: leaf.port_array(flat[leaf.path])
             for n, leaf in layout.items()}
    top = max(np.abs(w).max() for w in ports.values())
    cancelled = _cancelled_biases(model)
    for name, w in ports.items():
        scale = top if name in cancelled else np.abs(w).max()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert len(got) == len(flat)
    total = sum(float((w.astype(np.float64) ** 2).sum())
                for w in ports.values())
    assert total > 0
    np.testing.assert_allclose(float(norm), np.sqrt(total), rtol=1e-4)


def _initialised(fmod, variables):
    """``fmod`` whose ``init`` gives ``variables`` (this instance only, so
    that a fit in a thread leaves the class alone)."""
    object.__setattr__(fmod, "init", lambda *a, **k: jax.tree.map(
        jnp.asarray, variables))
    return fmod


def _jax_refs(variables):
    """JAX's unsharded two-epoch fit history from ``variables`` and its
    first step's gradient."""
    train, val = _data()
    dev = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    fmod = _initialised(j_eeg.TriModalFusionNetV4(**V4), variables)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        res = jax.jit(j_fit.make_fit_fn(
            fmod, JTrainConfig(**CFG1), eval_names=("val",)))(
                jax.random.key(7), dev(train), {"val": dev(val)}, None)
        hist = {k: np.asarray(res.history[k]) for k in KEYS}
    return hist, jax_step_grads(j_eeg.TriModalFusionNetV4(**V4), variables,
                                train, CFG1["batch_size"])


@pytest.fixture(scope="module")
def jax_refs(variables):
    """``_jax_refs`` as a future, computed in a thread while the port's
    world runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_refs, variables)


@pytest.fixture(scope="module")
def jax_fit(jax_refs):
    return jax_refs.result()[0]


@pytest.fixture(scope="module")
def port_runs(jax_refs, variables, tmp_path_factory):
    train, val = _data()
    fits = {name: (kind, shape, names, "v4", V4, variables, train,
                   {"val": val}, CFG1, None)
            for name, (kind, shape, names) in FITS.items()}
    ckpt = tmp_path_factory.mktemp("fsdp_resume")
    ranks = spawn_local_world(workers.sharded_fits, WORLD, fits,
                              (V4, variables, train, val, RESUME,
                               str(ckpt)))
    assert not any(jax_loaded for _, jax_loaded in ranks)
    return [r for r, _ in ranks]


def _specs_pair(fmod, model, inputs):
    params = jax.eval_shape(fmod.init, jax.random.key(0), **inputs)["params"]
    from flax import traverse_util

    layout = flax_layout(model)
    flat = traverse_util.flatten_dict(params)
    for name, leaf in layout.items():
        assert leaf.shape == tuple(flat[leaf.path].shape), name
    assert len(layout) == len(flat)
    return params, layout


def _carried(jax_specs, model, layout):
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax_specs)
    return {name: leaf.to_port(tuple(flat[leaf.path]),
                               model.get_parameter(name).dim())
            for name, leaf in layout.items()}


def _models():
    batch = {k: jnp.asarray(v) for k, v in _batch(3, 32).items()
             if k not in ("label", "weight")}
    v4_in = {k: batch[k] for k in ("erp", "pw", "conn")}
    return {"v4": (j_eeg.TriModalFusionNetV4(**V4),
                   TriModalFusionNetV4(**V4, device="cpu"), v4_in),
            "e2e": (JE2E(), MultimodalEndToEnd(device="cpu"), batch)}


@pytest.mark.parametrize("name", ["v4", "e2e"])
def test_tp_and_fsdp_specs_equal_jax(name):
    fmod, model, inputs = _models()[name]
    params, layout = _specs_pair(fmod, model, inputs)
    cases = {
        "tp": (j_tensor.tp_param_specs(params, n_model=4),
               tp_param_specs(model, 4)),
        "fsdp": (j_fsdp.fsdp_param_specs(params, n_shard=8),
                 fsdp_param_specs(model, 8)),
        "fsdp_tp": (j_fsdp.fsdp_param_specs(
            params, n_shard=2, base=j_tensor.tp_param_specs(params, 4)),
            fsdp_param_specs(model, 2, base=tp_param_specs(model, 4))),
    }
    for case, (want, got) in cases.items():
        want = _carried(want, model, layout)
        assert got == want, case
        assert any(got.values()), case


@pytest.mark.parametrize("name", sorted(FITS))
def test_sharded_fit_matches_jax(port_runs, jax_fit, name):
    for rank in port_runs:
        hist = rank[name][0]
        for k in KEYS:
            np.testing.assert_allclose(hist[k].numpy(), jax_fit[k],
                                       atol=1e-4, rtol=1e-4, err_msg=k)
            assert torch.equal(hist[k], port_runs[0][name][0][k])


@pytest.mark.parametrize("name", sorted(FITS))
def test_sharded_step_gradient_matches_jax(port_runs, jax_refs, name):
    want = jax_refs.result()[1]
    model = TriModalFusionNetV4(**V4, device="cpu")
    for rank in port_runs:
        grads, norm = rank[name][3]
        assert_grads_match_jax(model, grads, norm, want)


def test_fsdp_optimizer_state_is_a_quarter(port_runs):
    full = {k: p.numel() for k, p in
            TriModalFusionNetV4(**V4, device="cpu").named_parameters()}
    for rank in port_runs:
        _, local, opt_numel, _ = rank["fsdp"]
        sharded = {k for k, (_, spec) in local.items() if "data" in spec}
        for k in sharded:
            assert local[k][0] * WORLD == full[k], k
        assert sum(full[k] for k in sharded) / sum(full.values()) > 0.8
        assert opt_numel == sum(n for n, _ in local.values())
        assert opt_numel < 0.45 * sum(full.values())


def test_fsdp_resumable_crash_resume_matches_unsharded(port_runs, variables,
                                                       tmp_path):
    train, val = _data()
    ref = fit_resumable(workers._v4(V4, variables), TrainConfig(**RESUME), 0,
                        train, {"val": val}, tmp_path,
                        chunk_epochs=RESUME["num_epochs"] // 2)
    for rank in port_runs:
        for k in ("train_loss", "val_f1"):
            np.testing.assert_allclose(rank["resume"][k].numpy(),
                                       ref.history[k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
