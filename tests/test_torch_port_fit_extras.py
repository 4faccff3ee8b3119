"""The port's ``fit`` options past the basic one, against the JAX package.

``grad_accum`` and ``ema_decay`` are held to the JAX package's ``fit`` with
the same config on the narrow ``MultimodalEndToEnd`` of
``test_torch_port_train.py`` at T=32: histories within 1e-4; best epoch
equal; params within 1e-4, but for the biases whose gradient is zero up to
rounding (held to Adam's bound, as in ``test_fit_matches_jax``) and the
final raw params, held to the bound of ``tests/test_fit_extras.py`` (rtol
2e-2, atol 3e-3). Microbatches have 4 rows or more: BatchNorm over 2 rows
is so ill-conditioned that the two frameworks' f32 roundings part by 1e-3
in a weight after one epoch. The two frameworks draw different dropout masks and
permutations, so these comparisons run with flax's ``Dropout`` as the
identity, the fusion gates' fixed dropout off in the port, and both
shuffles as the identity; the JAX ``fit`` starts from the same seeded
variables as the port (its ``init`` returns them), which spares a compile.
The JAX fits are module-scoped and shared: each one takes ~17 s to trace and
compile on the CPU.

``resume_carry`` is held to the port itself: chunked and monolithic runs
with dropout and augmentation on are bit-identical. The bf16 mode is held
here to what it must keep in f32 and to the dtypes the flash layers see;
its comparison with the JAX package's bf16 ``fit`` is in
``test_torch_port_trainer.py``.
"""

import contextlib
import importlib
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    CLASS_WEIGHTS,
    NARROW,
    _assert_state_close,
    _batch,
    _cancelled_biases,
    _port_model,
)

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import arrays as j_arrays
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu_torch import MultimodalEndToEnd as TE2E
from multimodal_eeg_fmri_tpu_torch import init_weights
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.data import arrays as t_arrays
from multimodal_eeg_fmri_tpu_torch.models.layers import BatchNorm
from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
from multimodal_eeg_fmri_tpu_torch.train.evaluate import evaluate_dataset

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
t_fit = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.fit")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

T, N_TRAIN, N_VAL, BATCH, LR = 32, 24, 6, 12, 1e-3
FIT_KW = dict(batch_size=BATCH, num_epochs=2, learning_rate=LR,
              weight_decay=1e-2, grad_clip=0.5, loss="weighted_ce",
              selection="val", ema_decay=0.8)


def seeded_variables(n, T, seed=0):
    """Flax variables of the narrow model (structure from ``eval_shape``,
    no compile), filled from a seed: kernels N(0, 1/fan_in), norm scales
    and fusion logits near 1, biases and means near 0, variances in
    [0.5, 1.5]."""
    inputs = {k: jnp.zeros(v.shape, v.dtype)
              for k, v in t_fit.split_batch(_batch(n, T)).items()}
    shapes = jax.eval_shape(lambda: JE2E(**NARROW).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        **inputs, train=True))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (r.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = {"scale": 1.0, "fusion_logits": 1.0, "temperature": 1.0,
                "activation_weight": 0.5, "connectivity_weight": 0.5}
        return (base.get(name, 0.0)
                + 0.05 * r.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def exact_parity(variables):
    """flax's ``init`` returns ``variables``; flax ``Dropout`` and both
    shuffles are the identity."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE2E, "init", lambda self, *a, **k: jax.tree.map(
            jnp.asarray, variables))
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
        mp.setattr(torch, "randperm",
                   lambda n, generator=None, device=None: torch.arange(
                       n, device=device))
        yield


def data():
    train, val = _batch(N_TRAIN, T, seed=2), _batch(N_VAL, T, seed=3)
    val["weight"] = np.ones(N_VAL, np.float32)
    return train, val


def jax_fits(variables, configs):
    """JAX ``fit`` results, one per config: traced one after the other,
    compiled in parallel threads (XLA's compile releases the GIL)."""
    train, val = data()
    args = (jax.random.key(0), jax.tree.map(jnp.asarray, train),
            {"val": jax.tree.map(jnp.asarray, val)},
            jnp.asarray(CLASS_WEIGHTS))
    with exact_parity(variables):
        lowered = [jax.jit(j_fit.make_fit_fn(
            JE2E(**NARROW), JTrainConfig(**cfg_kw), eval_names=("val",))
        ).lower(*args) for cfg_kw in configs]
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    return [fn(*args) for fn in compiled]


def port_fit(variables, cfg_kw, **kw):
    train, val = data()
    model = _port_model(variables)
    with exact_parity(variables):
        res = t_fit.make_fit_fn(model, TrainConfig(**cfg_kw),
                                eval_names=("val",), **kw)(
            0, train, {"val": val}, CLASS_WEIGHTS)
    return model, res


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(BATCH, T)


ACCUM = (2, 3)  # microbatches of 6 and 4 rows


@pytest.fixture(scope="module")
def jax_accum_runs(variables):
    return dict(zip(ACCUM, jax_fits(
        variables, [dict(FIT_KW, grad_accum=a) for a in ACCUM])))


@pytest.fixture(scope="module", params=ACCUM)
def accum_runs(request, variables, jax_accum_runs):
    """(accum, JAX result, port model, port result) with EMA on."""
    model, res_t = port_fit(variables, dict(FIT_KW, grad_accum=request.param))
    return request.param, jax_accum_runs[request.param], model, res_t


# --- grad_accum ----------------------------------------------------------------

def test_grad_accum_matches_jax(accum_runs):
    """Histories within 1e-4 at every epoch, which pins the accumulated
    gradients; the final raw params within the bound of
    ``tests/test_fit_extras.py``; the BatchNorm statistics, threaded through
    the microbatches in order, within 1e-4."""
    accum, res_j, model, res_t = accum_runs
    assert set(res_t.history) == set(res_j.history)
    for k, v in res_j.history.items():
        np.testing.assert_allclose(res_t.history[k].numpy(), np.asarray(v),
                                   atol=1e-4, rtol=0, err_msg=k)
    want = _assert_state_close(
        {**res_t.final_params, **res_t.final_batch_stats}, res_j.final_params,
        res_j.final_batch_stats, 1e-4, skip=set(res_t.final_params))
    for k, p in res_t.final_params.items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=2e-2,
                                   atol=3e-3, err_msg=k)
    # two epochs of two steps, each over ``accum`` microbatches
    assert res_t.carry.opt_state["step"].item() == 4


def test_grad_accum_loss_is_the_scaled_sum():
    """One step: the reported loss is Σ_k (ŵ_k/W)·L_k, which with the
    loss's own denominator equals the full batch's loss, and the summed
    gradients are the full batch's (a LayerNorm-only model, dropout 0, so
    that microbatches change nothing but the summation)."""
    from multimodal_eeg_fmri_tpu_torch.models import ModelOutput
    from multimodal_eeg_fmri_tpu_torch.models.layers import MLP

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = MLP(5, (8, 2), norm="layer", final_activation=False)

        def forward(self, x):
            return ModelOutput(self.mlp(x))

    r = np.random.default_rng(4)
    batch = {"x": torch.from_numpy(r.standard_normal((6, 5), np.float32)),
             "label": torch.tensor([0, 1, 1, 0, 1, 0]),
             "weight": torch.from_numpy(r.uniform(0.2, 2.0, 6).astype(
                 np.float32))}
    cw = torch.tensor([0.7, 1.6])
    got = {}
    for k in (1, 2, 3):
        torch.manual_seed(0)
        net = Net()
        step = t_fit.TrainStep(net, TrainConfig(grad_accum=k))
        loss = step.objective(batch, cw)
        got[k] = (loss.item(), [p.grad.clone() for p in step.params])
    for k in (2, 3):
        assert got[k][0] == pytest.approx(got[1][0], abs=1e-6)
        for a, b in zip(got[k][1], got[1][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_frozen_steps_report_the_scaled_sum(variables):
    """Once early stopping has frozen the run, its steps still report the
    accumulated loss Σ_k (ŵ_k/W)·L_k, here of the frozen params on the
    whole training set as one batch."""
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, batch_size=N_TRAIN, num_epochs=3,
                             grad_accum=2, patience=1, min_delta=2.0))
    model = _port_model(variables)
    with exact_parity(variables):
        res = t_fit.make_fit_fn(model, cfg, eval_names=("val",))(
            0, train, {"val": val}, CLASS_WEIGHTS)
    assert res.carry.stopped and res.best_epoch.item() == 0
    with torch.no_grad():
        want = t_fit.TrainStep(model, cfg).objective(
            {k: torch.from_numpy(v) for k, v in train.items()},
            torch.from_numpy(CLASS_WEIGHTS), backward=False)
    np.testing.assert_allclose(res.history["train_loss"][2].item(),
                               want.item(), atol=1e-6, rtol=0)


def test_grad_accum_must_divide_batch(variables):
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, grad_accum=5))
    with pytest.raises(ValueError, match="grad_accum=5"):
        t_fit.make_fit_fn(_port_model(variables), cfg, eval_names=("val",))(
            0, train, {"val": val}, CLASS_WEIGHTS)


# --- ema_decay -----------------------------------------------------------------

def test_ema_matches_jax(accum_runs):
    """Best epoch, best metric and ``FitResult.params``, the EMA snapshot of
    the best epoch, with the raw BatchNorm statistics of that epoch, within
    1e-4; the biases whose gradient is zero up to rounding within Adam's
    bound of 4 steps at lr."""
    _, res_j, model, res_t = accum_runs
    assert res_t.best_epoch.item() == int(res_j.best_epoch)
    np.testing.assert_allclose(res_t.best_metric.item(),
                               float(res_j.best_metric), atol=1e-4)
    noisy = _cancelled_biases(model)
    _assert_state_close({**res_t.params, **res_t.batch_stats}, res_j.params,
                        res_j.batch_stats, 1e-4, noisy)
    want = _assert_state_close(res_t.carry.ema_params,
                               res_j.carry.ema_params,
                               res_j.final_batch_stats, 1e-4, noisy)
    for k in noisy:
        assert (res_t.carry.ema_params[k] - want[k]).abs().max() <= 4 * LR


def test_ema_with_batchnorm_selection_contract(variables):
    """The EMA covers the params only: ``FitResult.params`` is the EMA
    snapshot (it lags the raw params), ``.batch_stats`` the raw running
    statistics, and the best metric is reproduced exactly by evaluating
    that pair."""
    train, val = data()
    model = _port_model(variables)
    res = t_fit.make_fit_fn(model, TrainConfig(**dict(FIT_KW, num_epochs=3)),
                            eval_names=("val",))(0, train, {"val": val},
                                                 CLASS_WEIGHTS)
    assert any(isinstance(m, BatchNorm) for m in model.modules())
    assert res.best_epoch.item() >= 0
    ema, raw = res.carry.ema_params, res.carry.params
    assert set(ema) == set(raw) == set(res.params)
    assert not set(ema) & set(res.batch_stats)
    assert max((ema[k] - raw[k]).abs().max().item() for k in raw) > 1e-3
    metrics, _ = evaluate_dataset(model, res.params, res.batch_stats, val)
    assert metrics["f1"].item() == res.best_metric.item()


def test_ema_recurrence(variables):
    """After each step ema = d·ema + (1−d)·params, from the initial params;
    one-step epochs chained through ``resume_carry`` expose every step."""
    train, val = data()
    d = 0.6
    cfg = TrainConfig(**dict(FIT_KW, batch_size=N_TRAIN, num_epochs=1,
                             ema_decay=d))
    model = _port_model(variables)
    fit = t_fit.make_fit_fn(model, cfg, eval_names=("val",))
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    carry = None
    for _ in range(3):
        carry = fit(0, train, {"val": val}, CLASS_WEIGHTS,
                    resume_carry=carry).carry
        for k, e in ema.items():
            e.copy_(d * e + (1 - d) * carry.params[k])
            torch.testing.assert_close(carry.ema_params[k], e, atol=1e-7,
                                       rtol=1e-6)


# --- resume_carry --------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chunked_fit_equals_one_run(variables, compute_dtype):
    """One epoch, then one resumed from the carry, equal two at once,
    bit for bit, with dropout, the gates' dropout, augmentation, EMA,
    gradient accumulation and the cosine schedule on."""
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=2, grad_accum=2,
                             schedule="warmup_cosine", warmup_epochs=1,
                             compute_dtype=compute_dtype))

    def run(epochs, seed, carry=None):
        model = init_weights(TE2E(**dict(NARROW, dropout=0.3), device="cpu"),
                             torch.Generator().manual_seed(seed))
        torch.manual_seed(seed)
        return t_fit.make_fit_fn(model, cfg, num_epochs=epochs,
                                 eval_names=("val",),
                                 augment=make_eeg_augment(prob=0.5))(
            seed, train, {"val": val}, CLASS_WEIGHTS, resume_carry=carry)

    one = run(2, 0)
    first = run(1, 0)
    # other weights and generators: the carry must replace all of them
    second = run(1, 99, first.carry)
    for k, v in one.history.items():
        torch.testing.assert_close(
            torch.cat([first.history[k], second.history[k]]), v, atol=0,
            rtol=0, msg=k)
    for field in ("params", "batch_stats", "best_params", "best_batch_stats",
                  "ema_params"):
        for k, v in getattr(one.carry, field).items():
            torch.testing.assert_close(getattr(second.carry, field)[k], v,
                                       atol=0, rtol=0, msg=f"{field}.{k}")
    for k in ("exp_avg", "exp_avg_sq"):
        for name, v in one.carry.opt_state[k].items():
            torch.testing.assert_close(second.carry.opt_state[k][name], v,
                                       atol=0, rtol=0)
    assert second.carry.epoch == 2
    assert torch.equal(second.carry.rng, one.carry.rng)
    assert torch.equal(second.carry.torch_rng, one.carry.torch_rng)


def test_float64_data_trains_as_float32(variables):
    """Float64 arrays become float32 on the device, as the JAX package (x64
    off) makes them: the same run bit for bit."""
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=1))
    runs = []
    for dt in (np.float32, np.float64):
        cast = {k: v.astype(dt) if v.dtype == np.float32 else v
                for k, v in train.items()}
        runs.append(t_fit.make_fit_fn(_port_model(variables), cfg,
                                      eval_names=("val",))(
            0, cast, {"val": val}, CLASS_WEIGHTS))
    for k, v in runs[0].final_params.items():
        torch.testing.assert_close(runs[1].final_params[k], v, atol=0, rtol=0)


# --- compute_dtype="bfloat16" --------------------------------------------------

def test_bf16_step_keeps_f32_master_state(variables):
    """The forward runs in bf16; params, gradients, AdamW state and the
    BatchNorm running statistics stay f32, and the gradients reach the f32
    params through the cast."""
    train, _ = data()
    batch = {k: torch.from_numpy(v[:BATCH]) for k, v in train.items()}
    model = _port_model(variables)
    step = t_fit.TrainStep(model, TrainConfig(compute_dtype="bfloat16"))
    out = step.forward(step.inputs(batch))
    assert out.logits.dtype == torch.bfloat16
    assert step(batch, torch.from_numpy(CLASS_WEIGHTS)).dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        state = step.optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32
    assert max(p.grad.abs().max().item() for p in model.parameters()) > 0
    for name, b in model.named_buffers():
        if "running" in name:
            assert b.dtype == torch.float32, name


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="float16"):
        t_fit.make_fit_fn(torch.nn.Linear(2, 2),
                          TrainConfig(compute_dtype="float16"),
                          eval_names=("val",))


def test_bf16_flash_layers_take_bf16_and_eval_runs_f32(monkeypatch):
    """At T=256 the narrow model's PW layer takes the flash route: in a bf16
    train step its forward and backward get bf16 q/k/v with f32 operands
    (the bf16-storage instances of K1, K2 and K3 on the card); the
    evaluation's forward gets f32."""
    seen = []

    def recording(name):
        real = getattr(port_attn, name)

        def wrapper(q, *a):
            seen.append((name, q.dtype, a[-1]))
            return real(q, *a)

        monkeypatch.setattr(port_attn, name, wrapper)

    recording("_flash_forward")
    recording("_flash_backward")
    model = init_weights(TE2E(**NARROW, device="cpu"),
                         torch.Generator().manual_seed(1))
    train, val = _batch(4, 256, seed=5), _batch(4, 256, seed=6)
    res = t_fit.make_fit_fn(model, TrainConfig(
        batch_size=4, num_epochs=1, compute_dtype="bfloat16"),
        eval_names=("val",))(0, train, {"val": val}, CLASS_WEIGHTS)
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == [("_flash_forward", bf16, f32),
                    ("_flash_backward", bf16, f32),
                    ("_flash_forward", f32, f32)]
    assert np.isfinite(res.history["val_auc"].numpy()).all()


def _separable(n, T, seed):
    """A cohort whose class shifts every input by ±0.6."""
    d = _batch(n, T, seed=seed)
    y = np.arange(n) % 2
    for k in ("erp", "pw", "conn", "activation", "connectivity"):
        d[k] = d[k] + 0.6 * (2 * y - 1).reshape(-1, *[1] * (d[k].ndim - 1))
    d["label"], d["weight"] = y.astype(np.int32), np.ones(n, np.float32)
    return d


def test_bf16_training_learns():
    """bf16 training learns a separable task (the JAX package's
    ``test_bf16_training_learns``), and keeps f32 params and statistics."""
    model = init_weights(TE2E(**NARROW, device="cpu"),
                         torch.Generator().manual_seed(2))
    cfg = TrainConfig(batch_size=8, num_epochs=6, learning_rate=3e-3,
                      schedule="constant", selection="val", patience=100,
                      compute_dtype="bfloat16")
    torch.manual_seed(0)
    res = t_fit.make_fit_fn(model, cfg, eval_names=("val",))(
        0, _separable(24, T, 7), {"val": _separable(8, T, 8)})
    loss = res.history["train_loss"].numpy()
    assert loss[-1] < loss[0]
    assert res.best_metric.item() > 0.6
    for t in (*res.params.values(), *res.batch_stats.values()):
        assert t.dtype in (torch.float32, torch.int64)


# --- data/arrays.py: the port's copy -------------------------------------------

def test_array_helpers_match_jax():
    d = _batch(5, 4, seed=9)
    d.pop("weight")
    for got, want in ((t_arrays.pad_rows(d, 8), j_arrays.pad_rows(d, 8)),
                      (t_arrays.subset(d, [4, 0, 2]),
                       j_arrays.subset(d, [4, 0, 2]))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    labels = np.array([0, 1, 1, 1, 0, 1])
    w = np.array([1, 1, 0, 1, 1, 1], np.float32)
    np.testing.assert_array_equal(
        t_arrays.balanced_class_weights(labels, weights=w),
        j_arrays.balanced_class_weights(labels, weights=w))


@pytest.mark.parametrize("bad", ["scalar", "lengths", "float_label",
                                 "label_range", "weight_2d", "weight_neg"])
def test_validate_dataset_raises_as_jax(bad):
    d = {"erp": np.zeros((4, 3, 2), np.float32),
         "label": np.array([0, 1, 0, 1]),
         "weight": np.ones(4, np.float32)}
    if bad == "scalar":
        d["conn"] = np.float32(1.0)
    elif bad == "lengths":
        d["conn"] = np.zeros((3, 2), np.float32)
    elif bad == "float_label":
        d["label"] = d["label"].astype(np.float32)
    elif bad == "label_range":
        d["label"] = np.array([0, 1, 2, 1])
    elif bad == "weight_2d":
        d["weight"] = np.ones((4, 1), np.float32)
    else:
        d["weight"] = -d["weight"]
    with pytest.raises(ValueError) as want:
        j_arrays.validate_dataset(d, batch_size=2)
    with pytest.raises(ValueError) as got:
        t_arrays.validate_dataset(d, batch_size=2)
    assert str(got.value)[:50] == str(want.value)[:50]
