"""The port's expert parallelism (``parallel.expert``, ``MoEFFN(mesh,
expert_axis)``) and Mixture-of-Experts blocks on the ring, against the JAX
package's.

- ``ep_param_specs`` equals JAX's on ``LongContextClassifier`` and
  ``TriModalFusionNetV4`` with 4 experts.
- In a spawned world of 4 gloo ranks: the ``LongContextClassifier`` with 4
  top-2 experts (``tests/test_fsdp.py``'s FSDP×EP model: hidden 16, 2
  heads, one layer, T = 32 over 4 channels, 16 subjects in batches of 8, 2
  epochs) under FSDP×EP on (data 2 × expert 2), and on a ring of 4 (the
  time axis sharded, the experts routing the whole sequence), against
  JAX's unsharded fit (rtol 2e-4, atol 2e-5); ``TriModalFusionNetV4``
  with 4 experts under EP on (data 2 × expert 2) against JAX's unsharded
  two-epoch fit (1e-4, as ``tests/test_moe.py``). The shuffle is the
  identity on both sides. Each layout's first-step gradient (the aux loss
  included), reduced and gathered, against JAX's per tensor within 1e-4 of
  its largest entry, and its global norm.
- A layer whose capacity binds (capacity factor 0.5, top-2): its output
  rows and its gradients (input and parameters) on (data 2 × expert 2)
  against JAX's layer on the whole batch (1e-5); routing each rank's rows
  alone would give another function.
- Experts that do not divide the axis stay replicated and warn once.
"""

import concurrent.futures
import importlib
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import eeg as j_eeg
from multimodal_eeg_fmri_tpu.models import long_context as j_lc
from multimodal_eeg_fmri_tpu.ops import moe as j_moe
from multimodal_eeg_fmri_tpu.parallel import expert as j_expert
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.models import (
    LongContextClassifier,
    TriModalFusionNetV4,
)
from multimodal_eeg_fmri_tpu_torch.ops import moe as t_moe
from multimodal_eeg_fmri_tpu_torch.parallel import (
    Mesh,
    ep_param_specs,
    spawn_local_world,
)
from test_torch_port_moe import seeded_variables
from test_torch_port_sharding import (
    CFG1,
    _data,
    _initialised,
    _no_dropout,
    _specs_pair,
    assert_grads_match_jax,
    jax_step_grads,
)

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")

WORLD = 4
LC = dict(hidden_dim=16, num_layers=1, num_heads=2, dropout=0.0,
          num_experts=4, moe_top_k=2)
V4 = dict(hidden_dim=32, num_transformer_layers=1, num_heads=4, dropout=0.0,
          num_experts=4)
LC_CFG = dict(batch_size=8, num_epochs=2, learning_rate=1e-3,
              schedule="constant", selection="train_loss", patience=100)
MOE = dict(d_model=16, num_experts=4, top_k=2, capacity_factor=0.5)
T, C, N = 32, 4, 16


def _lc_data():
    r = np.random.default_rng(2)
    y = (np.arange(N) % 2).astype(np.int64)
    x = r.standard_normal((N, T, C)).astype(np.float32)
    x += 0.4 * (y * 2 - 1)[:, None, None]
    return {"erp": x, "label": y, "weight": np.ones(N, np.float32)}


def _tokens():
    r = np.random.default_rng(3)
    return (r.standard_normal((8, 6, 16)).astype(np.float32),
            r.standard_normal((8, 6, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def variables():
    train, _ = _data()
    v4_in = {k: train[k][:4] for k in ("erp", "pw", "conn")}
    return {
        "lc": seeded_variables(j_lc.LongContextClassifier(**LC),
                               kwargs=dict(erp=_lc_data()["erp"][:4]),
                               seed=2),
        "v4": seeded_variables(j_eeg.TriModalFusionNetV4(**V4),
                               kwargs=v4_in, seed=3),
        "moe": seeded_variables(j_moe.MoEFFN(**MOE), args=(_tokens()[0],),
                                seed=4),
    }


def _jax_runs(variables):
    """JAX's unsharded fits of both models, compiled in parallel threads,
    and their first steps' gradients: (histories, gradients) by model."""
    train, val = _data()
    dev = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    runs = {"lc": (j_lc.LongContextClassifier, LC, LC_CFG, dev(_lc_data()),
                   {}),
            "v4": (j_eeg.TriModalFusionNetV4, V4, CFG1, dev(train),
                   {"val": dev(val)})}
    lowered = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
        for name, (cls, kw, cfg, data, evals) in runs.items():
            fmod = _initialised(cls(**kw), variables[name])
            fn = jax.jit(j_fit.make_fit_fn(fmod, JTrainConfig(**cfg),
                                           eval_names=tuple(evals)))
            lowered[name] = (fn.lower(jax.random.key(0), data, evals, None),
                             data, evals)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = dict(zip(lowered, pool.map(lambda c: c[0].compile(),
                                              lowered.values())))
        hists = {name: {k: np.asarray(v) for k, v in
                        fn(jax.random.key(0), *lowered[name][1:], None)
                        .history
                        .items()}
                 for name, fn in done.items()}
    np_vars = jax.tree.map(np.asarray, variables)
    grads = {"lc": jax_step_grads(j_lc.LongContextClassifier(**LC),
                                  np_vars["lc"], _lc_data(),
                                  LC_CFG["batch_size"]),
             "v4": jax_step_grads(j_eeg.TriModalFusionNetV4(**V4),
                                  np_vars["v4"], train, CFG1["batch_size"])}
    return hists, grads


@pytest.fixture(scope="module")
def jax_refs(variables):
    """``_jax_runs`` as a future, computed in a thread while the port's
    world runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_runs, variables)


@pytest.fixture(scope="module")
def jax_runs(jax_refs):
    return jax_refs.result()[0]


@pytest.fixture(scope="module")
def port_runs(jax_refs, variables):
    np_vars = jax.tree.map(np.asarray, variables)
    train, val = _data()
    fits = {
        "lc_fsdp_ep": ("fsdp_ep", (2, 2), ("data", "expert"), "lc",
                       dict(LC, expert_axis="expert", in_channels=C),
                       np_vars["lc"], _lc_data(), {}, LC_CFG, None),
        "v4_ep": ("ep", (2, 2), ("data", "expert"), "v4",
                  dict(V4, expert_axis="expert"), np_vars["v4"], train,
                  {"val": val}, CFG1, None),
    }
    ranks = spawn_local_world(
        workers.expert_cases, WORLD, fits,
        (dict(LC, in_channels=C), np_vars["lc"]["params"], _lc_data(),
         LC_CFG),
        (MOE, np_vars["moe"], *_tokens()))
    assert not any(jax_loaded for _, jax_loaded in ranks)
    return [r for r, _ in ranks]


def _v4_port(**kw):
    return TriModalFusionNetV4(**V4, **kw, device="cpu")


@pytest.mark.parametrize("name", ["lc", "v4"])
def test_ep_specs_equal_jax(name):
    train, _ = _data()
    if name == "lc":
        fmod = j_lc.LongContextClassifier(**LC)
        model = LongContextClassifier(**LC, in_channels=C, device="cpu")
        inputs = {"erp": jnp.asarray(_lc_data()["erp"][:2])}
    else:
        fmod = j_eeg.TriModalFusionNetV4(**V4)
        model = _v4_port()
        inputs = {k: jnp.asarray(train[k][:2]) for k in ("erp", "pw", "conn")}
    params, layout = _specs_pair(fmod, model, inputs)
    from flax import traverse_util

    want = traverse_util.flatten_dict(j_expert.ep_param_specs(params, 2))
    got = ep_param_specs(model, 2)
    for k, leaf in layout.items():
        assert got[k] == leaf.to_port(tuple(want[leaf.path]),
                                      model.get_parameter(k).dim()), k
    assert sum(1 for s in got.values() if s) == 4 * (
        1 if name == "lc" else 2)


@pytest.mark.parametrize("name,ref,keys", [
    ("lc_fsdp_ep", "lc", ("train_loss",)),
    ("ring", "lc", ("train_loss",)),
    ("v4_ep", "v4", ("train_loss", "val_f1", "val_accuracy"))])
def test_expert_fits_match_jax(port_runs, jax_runs, name, ref, keys):
    tol = (dict(rtol=1e-4, atol=1e-4) if ref == "v4"
           else dict(rtol=2e-4, atol=2e-5))
    for rank in port_runs:
        hist = rank[name][0] if name != "ring" else rank[name]
        for k in keys:
            np.testing.assert_allclose(hist[k].numpy(), jax_runs[ref][k],
                                       err_msg=k, **tol)
    if name == "lc_fsdp_ep":
        # the experts over both axes: each rank holds a quarter of w1/w2
        _, local, _, _ = port_runs[0][name]
        two_d = [k for k, (_, spec) in local.items()
                 if "expert" in spec and "data" in spec]
        assert two_d


@pytest.mark.parametrize("name", ["lc_fsdp_ep", "v4_ep"])
def test_expert_step_gradient_matches_jax(port_runs, jax_refs, name):
    if name == "lc_fsdp_ep":
        model = LongContextClassifier(**LC, in_channels=C, device="cpu")
    else:
        model = _v4_port()
    want = jax_refs.result()[1]["lc" if name == "lc_fsdp_ep" else "v4"]
    for rank in port_runs:
        grads, norm = rank[name][3]
        assert_grads_match_jax(model, grads, norm, want)


def test_capacity_binding_routing_is_the_whole_batch(port_runs, variables):
    x, g = _tokens()
    layer = j_moe.MoEFFN(**MOE)
    v = variables["moe"]

    def loss(v, x):
        return jnp.sum(layer.apply(v, x) * g)

    want, (gv, gx) = jax.jit(lambda v, x: (layer.apply(v, x), jax.grad(
        loss, argnums=(0, 1))(v, x)))(v, jnp.asarray(x))
    S, k = x.shape[0] * x.shape[1], MOE["top_k"]
    kept = 0
    for rank, res in enumerate(port_runs):
        y, grads, rank_kept = res["capacity"]
        d = rank // 2  # the (data, expert) mesh's data index
        rows = slice(4 * d, 4 * d + 4)
        np.testing.assert_allclose(y.numpy(), np.asarray(want)[rows],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(grads["x"].numpy(), np.asarray(gx)[rows],
                                   atol=1e-5, rtol=0)
        e = rank % 2
        for name in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                grads[f"moe.{name}"].numpy(),
                np.asarray(gv["params"][name])[2 * e:2 * e + 2], atol=1e-5,
                rtol=0, err_msg=name)
        np.testing.assert_allclose(
            grads["moe.router.weight"].numpy(),
            np.asarray(gv["params"]["router"]["kernel"]).T, atol=1e-5,
            rtol=0)
        if e == 0:
            kept += rank_kept
    assert kept < S * k  # the capacity binds
    # each rank routing its own rows alone is another function
    port = load_flax_variables(t_moe.MoEFFN(**MOE, device="cpu"),
                               jax.tree.map(np.asarray, v)["params"])
    with torch.no_grad():
        alone = torch.cat([port(torch.from_numpy(x[r:r + 4]))
                           for r in (0, 4)])
    assert np.abs(alone.numpy() - np.asarray(want)).max() > 1e-3


def test_nondividing_experts_warn_once(caplog, monkeypatch, variables):
    monkeypatch.setattr(logging.getLogger("multimodal_eeg_fmri_tpu_torch"),
                        "propagate", True)
    mesh = Mesh(np.arange(2).reshape(1, 2), ("data", "expert"))
    kw = dict(d_model=16, num_experts=3)
    fvars = jax.tree.map(np.asarray, seeded_variables(
        j_moe.MoEFFN(**kw), args=(_tokens()[0],), seed=5))
    layer = load_flax_variables(t_moe.MoEFFN(**kw, mesh=mesh,
                                             expert_axis="expert",
                                             device="cpu"), fvars["params"])
    x = torch.from_numpy(_tokens()[0])
    t_moe._REPLICATION_WARNED.clear()
    with caplog.at_level(logging.WARNING,
                         logger="multimodal_eeg_fmri_tpu_torch.ops.moe"):
        with torch.no_grad():
            outs = [layer(x) for _ in range(2)]
    msgs = [r for r in caplog.records if "REPLICATED" in r.message]
    assert len(msgs) == 1
    want = jax.jit(j_moe.MoEFFN(**kw).apply)(
        jax.tree.map(jnp.asarray, fvars), jnp.asarray(x.numpy()))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
