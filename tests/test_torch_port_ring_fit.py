"""``LongContextClassifier(attn_impl="ring")`` trained through the port's
``fit`` in a spawned gloo world, against the JAX package's ring fit from
the same initial weights (``tests/test_long_context_training.py``'s model
and task: hidden 32, 1 layer, 4 heads, patch 2, T = 256 over 4 channels, 8
subjects in batches of 4, 3 epochs).

Two meshes: seq = 8 with the flash chunk (every hop through K1's plain
version forward and K2/K3's backward with the lse cotangent; the JAX side's
flash kernel in interpret mode), and seq 4 × model 2 with the heads
sharded, with the einsum chunk. For each: the train loss history within
rtol 2e-4, atol 2e-5 of JAX's, the same on every rank; one train step's
gradient (the mean over the mesh that ``fit`` applies) per tensor within
1e-4 of that tensor's largest |value| in JAX's gradient, but the key
projection's bias, whose gradient is zero up to rounding (it adds one
constant to a row of logits), within 1e-4 of the largest gradient; the
final params equal on every rank; and the ring model's state-dict keys the
single-device model's, the same flax variables loaded into both. The shuffles
are the identity on both sides (the model has no dropout), as in
``test_torch_port_long_context.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import long_context as j_lc
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
from multimodal_eeg_fmri_tpu_torch.parallel import spawn_local_world
from test_torch_port_moe import seeded_variables

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")

MODEL = dict(hidden_dim=32, num_layers=1, num_heads=4, dropout=0.0, patch=2)
T, C, N, B = 256, 4, 8, 4
CFG = dict(batch_size=B, num_epochs=3, learning_rate=1e-3,
           schedule="constant", selection="train_loss", patience=100,
           loss="weighted_ce")
CW = np.array([0.8, 1.3], np.float32)
HISTORY_RTOL, HISTORY_ATOL = 2e-4, 2e-5
GRAD_RTOL = 1e-4

# name: (mesh shape, axis names, seq axis, head axis, ring chunk)
MESHES = {
    "seq8_flash": ((8,), ("seq",), "seq", None, "flash"),
    "seq4_model2_einsum": ((4, 2), ("seq", "model"), "seq", "model",
                           "einsum"),
}


def _data():
    """The JAX test's task: class-dependent low-frequency drift."""
    r = np.random.default_rng(0)
    y = (np.arange(N) % 2).astype(np.int32)
    x = r.standard_normal((N, T, C)).astype(np.float32)
    drift = np.sin(np.linspace(0, 6 * np.pi, T))[None, :, None]
    x += (0.4 * (y * 2 - 1)[:, None, None] * drift).astype(np.float32)
    w = np.random.default_rng(1).uniform(0.5, 1.5, N).astype(np.float32)
    return {"erp": x, "label": y, "weight": w}


@pytest.fixture(scope="module")
def variables():
    v = seeded_variables(j_lc.LongContextClassifier(**MODEL),
                         kwargs=dict(erp=_data()["erp"][:B]), seed=3)
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def jax_runs(variables):
    """JAX's ring fit and one step's gradient on each mesh."""
    data = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_lc.LongContextClassifier, "init",
                   lambda self, *a, **k: jax.tree.map(jnp.asarray,
                                                      variables))
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
        real_lse = jax_attn.flash_attention_lse
        mp.setattr(jax_attn, "flash_attention_lse",
                   lambda q, k, v, bq=1024, bk=1024, interpret=False,
                   cdt=jnp.float32: real_lse(q, k, v, bq, bk, True, cdt))
        for name, (shape, names, seq, heads, impl) in MESHES.items():
            mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(shape), names)
            fmod = j_lc.LongContextClassifier(
                attn_impl="ring", mesh=mesh, seq_axis=seq, head_axis=heads,
                ring_chunk_impl=impl, **MODEL)

            def put(x, mesh=mesh, seq=seq):
                spec = P(None, seq, None) if x.ndim == 3 else P()
                return jax.device_put(jnp.asarray(x),
                                      NamedSharding(mesh, spec))

            dev = jax.tree.map(put, data)
            batch = {k: v[:B] for k, v in dev.items()}

            def loss(params, fmod=fmod, batch=batch):
                logits = fmod.apply({"params": params}, erp=batch["erp"],
                                    train=True).logits
                return j_losses.weighted_cross_entropy(
                    logits, batch["label"], jnp.asarray(CW),
                    batch["weight"])

            step_loss, grads = jax.jit(jax.value_and_grad(loss))(
                variables["params"])
            res = jax.jit(j_fit.make_fit_fn(fmod, JTrainConfig(**CFG),
                                            eval_names=()))(
                jax.random.key(0), dev, {}, jnp.asarray(CW))
            out[name] = (float(step_loss), jax.tree.map(np.asarray, grads),
                         np.asarray(res.history["train_loss"]))
    return out


@pytest.fixture(scope="module")
def port_runs(variables):
    """Both meshes in one world of 8 gloo ranks: {mesh: each rank's
    result}."""
    data = _data()
    batch = {k: v[:B] for k, v in data.items()}
    ranks = spawn_local_world(
        workers.ring_fits, 8, list(MESHES.values()),
        dict(MODEL, in_channels=C), variables["params"], data, batch, CFG,
        CW)
    assert not any(jax_loaded for _, jax_loaded in ranks)
    return {name: [r[0][i] for r in ranks] for i, name in enumerate(MESHES)}


def _flax_grads(grads):
    """JAX's gradient tree by the port's parameter names."""
    from multimodal_eeg_fmri_tpu_torch import load_flax_variables

    m = LongContextClassifier(**MODEL, in_channels=C, device="cpu")
    return {k: v.numpy() for k, v in
            load_flax_variables(m, grads).state_dict().items()}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_fit_matches_jax(jax_runs, port_runs, name):
    want_loss, want_grads, want_hist = jax_runs[name]
    want = _flax_grads(want_grads)
    g_max = max(np.abs(w).max() for w in want.values())
    ranks = port_runs[name]
    for keys, loss, grads, hist, params, _ in ranks:
        np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-6)
        for k, g in grads.items():
            w = want[k]
            limit = GRAD_RTOL * (g_max if k.endswith("k_proj.bias")
                                 else np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=limit,
                                       err_msg=k)
        np.testing.assert_allclose(hist.numpy(), want_hist,
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
        assert torch.equal(hist, ranks[0][3])
        for k, p in params.items():
            assert torch.equal(p, ranks[0][4][k]), k
    assert want_hist[-1] < want_hist[0]


def test_ring_model_state_dict_is_the_single_device_models(port_runs,
                                                           variables):
    from multimodal_eeg_fmri_tpu_torch import load_flax_variables

    single = load_flax_variables(
        LongContextClassifier(**MODEL, in_channels=C, device="cpu"),
        variables["params"])
    for ranks in port_runs.values():
        assert ranks[0][0] == list(single.state_dict())
