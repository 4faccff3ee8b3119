"""The port's training path against the JAX package's.

Losses, metrics, the optimizer's pieces, one train step of
``MultimodalEndToEnd(dropout=0.0)`` and a whole ``fit``, each on the same
numpy inputs and weights on both sides. Widths are narrow: hidden 32,
fMRI 16, bridge 32, one layer, two heads. Where the JAX side reaches its
flash kernels, they run in interpret mode, as the JAX package's own tests
run them. ``LearnedFusion``'s gate keeps a fixed dropout of 0.2 in training
whatever the model's ``dropout``, and the two frameworks draw different
masks, so the step and fit comparisons turn that one dropout off on both
sides. Tolerances: losses and metrics within 1e-6 (one f32 reduction); a
train step and a whole fit within 1e-4 (many f32 sums in another order,
as for the composite nets' forward).
"""

import dataclasses
import functools
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import layers as j_layers
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu.ops import augment as j_augment
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu.report import metrics as j_metrics
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import encoders as t_enc
from multimodal_eeg_fmri_tpu_torch.models import layers as t_layers
from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.models.multimodal import (
    MultimodalEndToEnd as TE2E,
)
from multimodal_eeg_fmri_tpu_torch.ops import augment as t_augment
from multimodal_eeg_fmri_tpu_torch.ops import losses as t_losses
from multimodal_eeg_fmri_tpu_torch.report import metrics as t_metrics

# the packages' ``ops.attention`` and ``train.fit`` attributes are
# functions, so the modules are looked up by name
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")
j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
t_fit = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.fit")

NARROW = dict(eeg_hidden_dim=32, fmri_hidden_dim=16, bridge_dim=32,
              num_transformer_layers=1, num_heads=2, dropout=0.0)
CLASS_WEIGHTS = np.array([0.8, 1.3], np.float32)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(n, T, seed=0):
    r = np.random.default_rng(seed + 100)
    weight = np.ones(n, np.float32)
    weight[-1] = 0.0  # a padding row
    return dict(erp=_x(n, T, 18, seed=seed), pw=_x(n, T, 75, seed=seed + 1),
                conn=_x(n, 459, seed=seed + 2),
                activation=_x(n, 90, seed=seed + 3),
                connectivity=_x(n, 64, seed=seed + 4),
                label=np.arange(n, dtype=np.int32) % 2,
                weight=weight * r.uniform(0.5, 1.5, n).astype(np.float32))


def _port_model(variables):
    """A CPU port of the narrow model with the flax variables, and the
    fusion gates' fixed dropout off."""
    model = load_flax_variables(TE2E(**NARROW, device="cpu"),
                                variables["params"], variables["batch_stats"])
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    return model


@pytest.fixture
def no_gate_dropout(monkeypatch):
    """flax Dropout as the identity: with dropout=0.0 only the fusion gate's
    fixed rate is left, and the two frameworks cannot share its masks."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


@pytest.fixture
def flash_counts(monkeypatch):
    """Route the JAX flash kernels through interpret mode and count the
    flash forwards and backwards on both sides (JAX counts while tracing)."""
    counts = {"jax_fwd": 0, "jax_bwd": 0, "port_fwd": 0, "port_bwd": 0}

    def counting(module, name, key, **extra):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            counts[key] += 1
            return real(*a, **kw, **extra)

        monkeypatch.setattr(module, name, wrapper)

    counting(jax_attn, "flash_attention", "jax_fwd", interpret=True)
    counting(jax_attn, "_flash_backward", "jax_bwd")
    counting(port_attn, "_flash_forward", "port_fwd")
    counting(port_attn, "_flash_backward", "port_bwd")
    return counts


def _zscore_j(inputs):
    return {k: (inputs[k] - inputs[k].mean(axis=(1, 2), keepdims=True))
            / (inputs[k].std(axis=(1, 2), keepdims=True) + 1e-8)
            for k in ("erp", "pw")}


def _zscore_t(inputs):
    return {k: (inputs[k] - inputs[k].mean(dim=(1, 2), keepdim=True))
            / (inputs[k].std(dim=(1, 2), keepdim=True, correction=0) + 1e-8)
            for k in ("erp", "pw")}


def _assert_state_close(port_state, flax_params, flax_stats, atol,
                        skip=frozenset()):
    """Compare tensors of a port state dict (or gradients, by parameter
    name), but those named in ``skip``, with flax variables, mapped by
    ``load_flax_variables`` into a fresh module; returns that module's
    state dict. Every parameter must be among them."""
    ref = load_flax_variables(TE2E(**NARROW, device="cpu"),
                              jax.tree.map(np.asarray, flax_params),
                              jax.tree.map(np.asarray, flax_stats))
    want = ref.state_dict()
    assert {k for k, _ in ref.named_parameters()} <= set(port_state)
    for name, got in port_state.items():
        if name.endswith("num_batches_tracked") or name in skip:
            continue
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)
    return want


def _cancelled_biases(model):
    """Names of the biases whose gradient is zero up to rounding: those that
    feed a BatchNorm directly, which the norm cancels in training mode, and
    every attention's key-projection bias, which adds one constant to a
    row of logits and so cancels in the softmax."""
    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, t_layers.MultiHeadAttention):
            names.add(f"{prefix}.k_proj.bias")
        elif isinstance(m, t_enc.ConvBNBlock):
            names.add(f"{prefix}.conv.bias")
        elif isinstance(m, t_enc.MultiScaleConv):
            names.add(f"{prefix}.bias")
        elif isinstance(m, t_layers.MLP) and m.norm == "batch":
            names |= {f"{prefix}.dense_{i}.bias" for i in range(m.n)
                      if hasattr(m, f"bn_{i}")}
    return names


# --- losses, metrics, config ------------------------------------------------

LOSSES = ["ce", "weighted_ce", "focal", "label_smoothing", "mse"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name, weighted):
    r = np.random.default_rng(1)
    n = 12
    if name == "mse":
        logits, labels = _x(n, seed=2), _x(n, seed=3)
    else:
        logits, labels = 3 * _x(n, 3, seed=2), r.integers(0, 3, n)
    sw = r.uniform(0, 2, n).astype(np.float32) if weighted else None
    cw = np.array([0.5, 1.0, 2.0], np.float32)
    kw = {"alpha": 0.4, "gamma": 1.5} if name == "focal" else {}
    want = j_losses.make_loss_fn(name, **kw)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw),
        None if sw is None else jnp.asarray(sw))
    got = t_losses.make_loss_fn(name, **kw)(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(cw), None if sw is None else torch.from_numpy(sw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        t_losses.make_loss_fn("hinge")


@pytest.mark.parametrize("weighted", [False, True])
def test_classification_metrics_match_jax_with_ties(weighted):
    r = np.random.default_rng(4)
    n = 20
    # rows repeated, so that scores tie within and across classes
    logits = np.repeat(_x(5, 2, seed=5), 4, axis=0)
    labels = r.integers(0, 2, n).astype(np.int32)
    w = r.uniform(0, 1, n).astype(np.float32) if weighted else None
    w_j = None if w is None else jnp.asarray(w)
    w_t = None if w is None else torch.from_numpy(w)
    want = j_metrics.binary_classification_metrics(
        jnp.asarray(logits), jnp.asarray(labels), w_j)
    got = t_metrics.binary_classification_metrics(
        torch.from_numpy(logits), torch.from_numpy(labels), w_t)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(
        t_metrics.auc_roc(torch.from_numpy(logits[:, 0]),
                          torch.from_numpy(labels), w_t).item(),
        float(j_metrics.auc_roc(jnp.asarray(logits[:, 0]),
                                jnp.asarray(labels), w_j)), atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(weighted):
    p, t = _x(15, seed=6), _x(15, seed=7)
    w = np.random.default_rng(8).uniform(0, 1, 15).astype(np.float32)
    want = j_metrics.regression_metrics(jnp.asarray(p), jnp.asarray(t),
                                        jnp.asarray(w) if weighted else None)
    got = t_metrics.regression_metrics(torch.from_numpy(p),
                                       torch.from_numpy(t),
                                       torch.from_numpy(w) if weighted
                                       else None)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_train_config_copies_jax_fields_and_defaults():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(TrainConfig) == fields(JTrainConfig)


def test_clip_by_global_norm_matches_optax():
    for scale, max_norm in ((0.1, 1.0), (10.0, 1.0), (1.0, 0.5)):
        grads = [scale * _x(3, 4, seed=9), scale * _x(5, seed=10)]
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g) for g in grads]
        t_fit.clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)


def test_lr_schedules_match_jax():
    cfg_j, cfg_t = (cls(num_epochs=8, warmup_epochs=3, plateau_patience=1,
                        schedule="warmup_cosine")
                    for cls in (JTrainConfig, TrainConfig))
    for e in range(10):
        np.testing.assert_allclose(
            t_fit._cosine_scale(cfg_t, e).item(),
            float(j_fit._cosine_scale(cfg_j, jnp.asarray(e))), atol=1e-7)
    state_j = (jnp.float32(np.inf), jnp.int32(0), jnp.float32(1.0))
    state_t = (torch.tensor(np.inf), torch.tensor(0), torch.tensor(1.0))
    for loss in (1.0, 0.9, 0.95, 0.95, 0.96, 0.5, 0.6, 0.7):
        state_j = j_fit._plateau_update(cfg_j, *state_j, jnp.float32(loss))
        state_t = t_fit._plateau_update(cfg_t, *state_t,
                                        torch.tensor(loss))
        for a, b in zip(state_t, state_j):
            np.testing.assert_allclose(a.item(), float(b), atol=1e-7)


# --- augmentation -----------------------------------------------------------

def _augment_stats(x, y):
    """(noise-gate share, drop-gate share, dropped share of the channels of
    drop-gated samples, noise std / sample std, whole channels zeroed)."""
    zeroed = np.all(y == 0, axis=1)                        # (B, C)
    some_zero = np.any(y == 0, axis=1)
    dropped = zeroed.any(axis=1)
    kept = ~zeroed[:, None, :] & np.ones_like(x, bool)
    diff = np.where(kept, y - x, 0.0)
    noised = np.abs(diff).max(axis=(1, 2)) > 0
    std = x.std(axis=(1, 2))
    rel = (diff[noised] / std[noised, None, None])[kept[noised]]
    return (noised.mean(), dropped.mean(), zeroed[dropped].mean(), rel.std(),
            bool(np.array_equal(zeroed, some_zero)))


def test_augment_temporal_statistics_match_jax():
    B, T, C = 1000, 8, 64
    x = (1.0 + np.abs(_x(B, T, C, seed=11))) * np.random.default_rng(
        12).uniform(0.5, 3.0, (B, 1, 1)).astype(np.float32)
    y_t = t_augment.augment_temporal(torch.Generator().manual_seed(0),
                                     torch.from_numpy(x))
    y_j = j_augment.augment_temporal(jax.random.key(0), jnp.asarray(x))
    assert y_t.shape == x.shape and y_t.dtype == torch.float32
    for y in (y_t.numpy(), np.asarray(y_j)):
        noise_share, drop_share, chan_share, rel_std, whole = \
            _augment_stats(x, y)
        # gates: binomial(1000, 0.3), 4.5 sigma = 0.065
        assert abs(noise_share - 0.3) < 0.065
        assert abs(drop_share - 0.3) < 0.065
        # ~300 gated samples x 64 channels at 0.1: 4.5 sigma = 0.015
        assert abs(chan_share - 0.1) < 0.015
        # ~150k noise draws: the std is 0.05 within 1%
        assert abs(rel_std - 0.05) < 5e-4
        assert whole


def test_make_eeg_augment_touches_only_its_keys():
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, 16).items()}
    out = t_augment.make_eeg_augment(prob=1.0)(
        torch.Generator().manual_seed(1), batch)
    assert not torch.equal(out["erp"], batch["erp"])
    assert not torch.equal(out["pw"], batch["pw"])
    for k in ("conn", "activation", "connectivity", "label", "weight"):
        assert out[k] is batch[k]


# --- the repairs --------------------------------------------------------------

@pytest.mark.parametrize("cls", [TE2E, TriModalFusionNetV4, FMRIFusionNet,
                                 BridgeFusionNet])
def test_models_build_on_the_gpu_unless_asked(cls):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()
    assert next(cls(device="cpu").parameters()).device.type == "cpu"


def test_batch_norm_2d_train_mode_matches_jax():
    """The MLP's BatchNorm on (B, C): flax's batch statistics and its
    running-variance update with the biased variance."""
    x = 2.0 + 3.0 * _x(6, 20)
    fmod, tmod = j_layers.MLP((24,)), t_layers.MLP(20, (24,))
    variables = fmod.init(jax.random.key(0), jnp.asarray(x))
    load_flax_variables(tmod, jax.tree.map(np.asarray, variables["params"]),
                        jax.tree.map(np.asarray, variables["batch_stats"]))
    ref, upd = fmod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    out = tmod.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    for key, buf in (("mean", tmod.bn_0.running_mean),
                     ("var", tmod.bn_0.running_var)):
        np.testing.assert_allclose(
            buf.numpy(), np.asarray(upd["batch_stats"]["bn_0"][key]),
            atol=1e-6, rtol=0)


# --- one train step and a whole fit ----------------------------------------

def _flax_variables(T_init=32, seed=0):
    """Initial flax variables of the narrow model, perturbed off their
    trivial values with seeded noise."""
    fmod = JE2E(**NARROW)
    inputs = {k: jnp.asarray(v) for k, v in t_fit.split_batch(
        _batch(3, T_init)).items()}
    variables = jax.jit(fmod.init)(jax.random.key(seed), **inputs)
    r = np.random.default_rng(seed + 1)
    return fmod, jax.tree_util.tree_map_with_path(
        lambda path, v: (r.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                         if path[-1].key == "var" else
                         np.asarray(v) + 0.05 * r.standard_normal(
                             np.shape(v)).astype(np.float32)), variables)


@pytest.mark.parametrize("T,flash", [(64, 0), (512, 2)])
def test_train_step_matches_jax(no_gate_dropout, flash_counts, T, flash):
    """Loss, every gradient and the updated BatchNorm statistics of one
    train-mode step with weighted CE. At T=512 the ERP and PW layers take
    the flash route (one layer each here) forward and backward."""
    fmod, variables = _flax_variables()
    port = _port_model(variables)
    batch = _batch(4, T, seed=1)
    inputs = {k: jnp.asarray(v) for k, v in t_fit.split_batch(batch).items()}

    def loss_fn(params):
        out, mut = fmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            **inputs, train=True, mutable=["batch_stats"])
        return j_losses.weighted_cross_entropy(
            out.logits, jnp.asarray(batch["label"]),
            jnp.asarray(CLASS_WEIGHTS), jnp.asarray(batch["weight"])
        ), mut["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    step = t_fit.TrainStep(port, TrainConfig())
    loss_t = step.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(CLASS_WEIGHTS))
    loss_t.backward()
    assert flash_counts == {"jax_fwd": flash, "jax_bwd": flash,
                            "port_fwd": flash, "port_bwd": flash}
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    grads_t = {k: p.grad for k, p in port.named_parameters()}
    _assert_state_close(grads_t, grads_j, stats_j, 1e-4)
    _assert_state_close(port.state_dict(), variables["params"], stats_j, 1e-4)


def test_fit_matches_jax(no_gate_dropout, flash_counts):
    """A whole fit: 2 epochs of weighted CE with z-score preprocessing,
    clipping, AdamW and plateau LR, selection on ``val``. The batch is the
    whole training set, so the shuffle only permutes rows inside it. The
    initial weights are the JAX fit's own (split the key, ``model.init`` on
    the first batch in train mode). A bias that feeds a BatchNorm or
    projects the attention keys has a gradient that is zero up to rounding,
    which Adam scales to up to about ±lr a step, differently in each
    framework: those biases are held to Adam's bound on both sides, every
    other tensor to 1e-4."""
    T, n = 256, 6
    train, val = _batch(n, T, seed=2), _batch(4, T, seed=3)
    val["weight"] = np.ones(4, np.float32)
    cfg_kw = dict(batch_size=n, num_epochs=2, learning_rate=1e-3,
                  weight_decay=1e-2, grad_clip=0.5, loss="weighted_ce",
                  selection="val", plateau_patience=0, plateau_factor=0.5)
    fmod = JE2E(**NARROW)
    key = jax.random.key(0)
    _, init_rng, drop_rng = jax.random.split(key, 3)
    variables = jax.jit(functools.partial(fmod.init, train=True))(
        {"params": init_rng, "dropout": drop_rng},
        **{k: jnp.asarray(v) for k, v in t_fit.split_batch(train).items()})
    variables = jax.tree.map(np.asarray, variables)
    res_j = jax.jit(j_fit.make_fit_fn(
        fmod, JTrainConfig(**cfg_kw), eval_names=("val",),
        preprocess=_zscore_j))(
        key, {k: jnp.asarray(v) for k, v in train.items()},
        {"val": {k: jnp.asarray(v) for k, v in val.items()}},
        jnp.asarray(CLASS_WEIGHTS))

    port = _port_model(variables)
    initial = {k: p.detach().clone() for k, p in port.named_parameters()}
    res_t = t_fit.make_fit_fn(port, TrainConfig(**cfg_kw),
                              eval_names=("val",), preprocess=_zscore_t)(
        0, train, {"val": val}, CLASS_WEIGHTS)
    # PW at T=256 takes the flash route: 2 train steps, 2 evals
    assert flash_counts["port_fwd"] == 4 and flash_counts["port_bwd"] == 2
    assert set(res_t.history) == set(res_j.history)
    for k, v in res_j.history.items():
        assert res_t.history[k].shape == (2,)
        np.testing.assert_allclose(res_t.history[k].numpy(), np.asarray(v),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert res_t.best_epoch.item() == int(res_j.best_epoch)
    np.testing.assert_allclose(res_t.best_metric.item(),
                               float(res_j.best_metric), atol=1e-4)
    noisy = _cancelled_biases(port)
    assert len(noisy) == 18
    _assert_state_close({**res_t.params, **res_t.batch_stats},
                        res_j.params, res_j.batch_stats, 1e-4, noisy)
    final_j = _assert_state_close(
        {**res_t.final_params, **res_t.final_batch_stats},
        res_j.final_params, res_j.final_batch_stats, 1e-4, noisy)
    # two Adam steps move a parameter by at most ~2·lr (|m̂|/√v̂ ≤ 1 here)
    for k in noisy:
        for final in (res_t.final_params[k], final_j[k]):
            assert (final - initial[k]).abs().max().item() <= 2.5e-3, k
    # the other params moved far beyond the tolerance
    assert max((res_t.final_params[k] - v).abs().max().item()
               for k, v in initial.items() if k not in noisy) > 1e-3


def test_early_stopping_freezes_the_run(no_gate_dropout):
    """Once stopped, params, BatchNorm statistics and optimizer state stay
    as they were and the epochs still count: four epochs that stop after
    the second end where two epochs end."""
    _, variables = _flax_variables()
    train, val = _batch(8, 32, seed=4), _batch(4, 32, seed=5)
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3, patience=1,
                      min_delta=2.0, schedule="constant")
    results = []
    for epochs in (2, 4):
        port = _port_model(variables)
        results.append(t_fit.make_fit_fn(port, cfg, num_epochs=epochs,
                                         eval_names=("val",))(
            3, train, {"val": val}, CLASS_WEIGHTS))
    two, four = results
    assert four.history["train_loss"].shape == (4,)
    assert four.best_epoch.item() == 0
    for k, v in two.final_params.items():
        torch.testing.assert_close(four.final_params[k], v, atol=0, rtol=0)
    for k, v in two.final_batch_stats.items():
        torch.testing.assert_close(four.final_batch_stats[k], v, atol=0,
                                   rtol=0)
    torch.testing.assert_close(four.history["val_f1"][2:],
                               four.history["val_f1"][1].expand(2))


@pytest.mark.parametrize("what", ["grad_accum", "ema_decay", "compute_dtype",
                                  "param_sharding", "resume_carry"])
def test_unported_fit_options_raise(what):
    cfg = TrainConfig(**{"grad_accum": {"grad_accum": 2},
                         "ema_decay": {"ema_decay": 0.9},
                         "compute_dtype": {"compute_dtype": "bfloat16"}}.get(
        what, {}))
    model = t_layers.MLP(4, (2,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit = t_fit.make_fit_fn(
            model, cfg, eval_names=("val",),
            param_sharding=(lambda p: p) if what == "param_sharding"
            else None)
        fit(0, {}, {}, resume_carry=object())
