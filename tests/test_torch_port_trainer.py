"""The port's ``Trainer``, evaluation, schedules, checkpoints, chunked
``fit_resumable`` and bf16 ``fit``, against the JAX package where it has the
same function.

The JAX runs (the JAX ``Trainer``'s two epochs and its evaluation, and a
bf16 ``fit``) are module-scoped and shared; they start from the seeded
variables of ``test_torch_port_fit_extras.py`` with flax's ``Dropout`` and
both shuffles as the identity, and train on the whole training set as one
batch. Tolerances: ``Trainer`` losses, params and metrics within 1e-4 (the
biases whose gradient is zero up to rounding within Adam's bound, as in
``test_fit_matches_jax``); a JAX carry resumed in the port within 1e-4 of
the JAX ``Trainer``'s second epoch, resumed from the same carry; the
schedules within 1e-7 of optax and of the JAX classes. The JAX package's
bf16 ``fit`` is compiled without excess precision, so that every op rounds
to bf16 where its program says (by default XLA on the CPU keeps fused
chains in f32; ``test_torch_port_mixed_precision.py`` holds the port's
layers to that program one by one). The port's bf16 history lies 4.16e-4
from it after two epochs, in the train loss, and is held at 5e-4; the f32
history lies 6.54e-4 from it and would fail. What is left includes the backward's bias
sums, which XLA on the CPU accumulates in bf16 (seen in its compiled
program) and torch in f32.
``fit_resumable``'s crash-and-resume and ``Trainer``'s checkpoint
round trip are held to uninterrupted runs of the port bit for bit.
"""

import dataclasses
import importlib
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fit_extras import (
    FIT_KW,
    N_TRAIN,
    T,
    data,
    exact_parity,
    seeded_variables,
)
from test_torch_port_train import (
    CLASS_WEIGHTS,
    NARROW,
    _assert_state_close,
    _batch,
    _cancelled_biases,
    _port_model,
)

from multimodal_eeg_fmri_tpu.core import checkpoint as j_ckpt
from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu.ops import schedules as j_sched
from multimodal_eeg_fmri_tpu.train import evaluate as j_eval
from multimodal_eeg_fmri_tpu.train.trainer import Trainer as JTrainer
from multimodal_eeg_fmri_tpu_torch import MultimodalEndToEnd as TE2E
from multimodal_eeg_fmri_tpu_torch import carry_from_jax, init_weights
from multimodal_eeg_fmri_tpu_torch.core import checkpoint as t_ckpt
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.ops import schedules as t_sched
from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
from multimodal_eeg_fmri_tpu_torch.train import evaluate as t_eval
from multimodal_eeg_fmri_tpu_torch.train.resilient import (
    fit_resumable,
    latest_chunk,
)
from multimodal_eeg_fmri_tpu_torch.train.trainer import Trainer

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
t_fit = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.fit")

LR = FIT_KW["learning_rate"]
# full batch, two epochs; warmup_cosine makes the JAX Trainer build its
# carry before the first epoch (scale 0.5), so that it compiles once
TRAINER_KW = dict(FIT_KW, batch_size=N_TRAIN, schedule="warmup_cosine",
                  warmup_epochs=2)
BF16_KW = dict(FIT_KW, batch_size=N_TRAIN, ema_decay=0.0)
BF16_ATOL = 5e-4


def _host(tree):
    """A JAX carry with numpy leaves (the PRNG key as its raw bits)."""
    def leaf(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(x))
        return np.asarray(x)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(N_TRAIN, T)


@pytest.fixture(scope="module")
def jax_runs(variables):
    """The JAX ``Trainer``'s carry after each of two epochs, its losses,
    its evaluation on ``val``, and a bf16 ``fit`` compiled without excess
    precision, on a thread beside the ``Trainer``'s."""
    train, val = data()
    dev = {k: jnp.asarray(v) for k, v in train.items()}
    args = (jax.random.key(0), dev, {"val": jax.tree.map(jnp.asarray, val)},
            jnp.asarray(CLASS_WEIGHTS))
    out = {}
    with exact_parity(variables), ThreadPoolExecutor(1) as pool:
        bf16 = pool.submit(jax.jit(j_fit.make_fit_fn(
            JE2E(**NARROW), JTrainConfig(**dict(BF16_KW,
                                                compute_dtype="bfloat16")),
            eval_names=("val",))).lower(*args).compile,
            compiler_options={"xla_allow_excess_precision": False})
        tr = JTrainer(JE2E(**NARROW), JTrainConfig(**TRAINER_KW))
        out["losses"] = [tr.train_one_epoch(train, CLASS_WEIGHTS)]
        out["carry1"] = _host(tr._carry)
        out["losses"].append(tr.train_one_epoch(train, CLASS_WEIGHTS))
        out["carry2"] = _host(tr._carry)
        metrics, model_out = j_eval.evaluate_dataset(
            JE2E(**NARROW), tr.eval_params, tr._carry.batch_stats,
            jax.tree.map(jnp.asarray, val))
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["logits"] = np.asarray(model_out.logits)
        out["bf16"] = bf16.result()(*args)
    return out


# --- Trainer -------------------------------------------------------------------

def _close_to_jax(port_params, flax_params, flax_stats, model, steps):
    """Every param within 1e-4 of the flax ones but the noisy biases, held
    to Adam's bound of ``steps`` steps at lr."""
    noisy = _cancelled_biases(model)
    want = _assert_state_close(port_params, flax_params, flax_stats, 1e-4,
                               noisy)
    for k in noisy:
        assert (port_params[k] - want[k]).abs().max() <= steps * LR + 1e-4


def test_trainer_matches_jax_trainer(variables, jax_runs):
    """Two epochs of the port's ``Trainer`` (warmup-cosine on the host, EMA
    on): losses, the raw and EMA params, and ``evaluate`` (on the EMA)."""
    train, val = data()
    model = _port_model(variables)
    tr = Trainer(model, TrainConfig(**TRAINER_KW))
    with exact_parity(variables):
        losses = [tr.train_one_epoch(train, CLASS_WEIGHTS) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_runs["losses"], atol=1e-4, rtol=0)
    assert tr.epoch == 2 and tr.history["train_loss"] == losses
    c = jax_runs["carry2"]
    _close_to_jax({**tr.params, **tr.batch_stats}, c.params, c.batch_stats,
                  model, 2)
    _close_to_jax(tr.eval_params, c.ema_params, c.batch_stats, model, 2)
    got = tr.evaluate(val)
    assert set(got) == set(jax_runs["metrics"])
    for k, v in jax_runs["metrics"].items():
        assert got[k] == pytest.approx(v, abs=1e-4), k
    assert tr.update_best(got["f1"]) and tr.best_state[0] is tr.eval_params


def test_jax_carry_resumes_in_the_port(variables, jax_runs):
    """The JAX ``Trainer``'s carry after one epoch, converted by
    ``carry_from_jax``, trains one more epoch in the port's ``fit``: the
    loss, params, EMA, AdamW moments and step within 1e-4 of the JAX
    ``Trainer``'s second epoch from the same carry."""
    train, _ = data()
    model = _port_model(variables)
    c1, c2 = jax_runs["carry1"], jax_runs["carry2"]
    carry = carry_from_jax(model, c1)
    assert carry.epoch == 1 and carry.opt_state["step"].item() == 1
    # the host's warmup-cosine scale of the second epoch, as the JAX
    # Trainer sets it
    carry = carry._replace(lr_scale=torch.tensor(1.0))
    one_epoch = dataclasses.replace(TrainConfig(**TRAINER_KW),
                                    schedule="constant",
                                    selection="train_loss", patience=10**9)
    with exact_parity(variables):
        res = t_fit.make_fit_fn(model, one_epoch, num_epochs=1,
                                eval_names=())(
            0, train, {}, CLASS_WEIGHTS, resume_carry=carry)
    np.testing.assert_allclose(res.history["train_loss"].numpy(),
                               [jax_runs["losses"][1]], atol=1e-4, rtol=0)
    _close_to_jax({**res.final_params, **res.final_batch_stats}, c2.params,
                  c2.batch_stats, model, 2)
    _close_to_jax(res.carry.ema_params, c2.ema_params, c2.batch_stats,
                  model, 2)
    want = carry_from_jax(model, c2)
    assert res.carry.opt_state["step"].item() == 2
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in want.opt_state[key].items():
            np.testing.assert_allclose(res.carry.opt_state[key][k].numpy(),
                                       v.numpy(), atol=1e-4, rtol=0,
                                       err_msg=f"{key}.{k}")


def _dropout_model(seed=0):
    return init_weights(TE2E(**dict(NARROW, dropout=0.3), device="cpu"),
                        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_trainer_checkpoint_round_trip(tmp_path, ema):
    """save → load into a fresh trainer → continue equals uninterrupted
    training bit for bit, with dropout and augmentation on: params,
    statistics, AdamW state, both generators, the EMA, the epoch counter
    and the host controllers survive the round trip."""
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=4, ema_decay=ema,
                             schedule="warmup_cosine", warmup_epochs=2))

    def trainer(seed):
        torch.manual_seed(seed)
        return Trainer(_dropout_model(seed), cfg,
                       augment=make_eeg_augment(prob=0.5), generator=seed)

    full = trainer(0)
    ref = [full.train_one_epoch(train, CLASS_WEIGHTS) for _ in range(3)]
    first = trainer(0)
    got = [first.train_one_epoch(train, CLASS_WEIGHTS) for _ in range(2)]
    first.update_best(first.evaluate(val)["f1"])
    path = first.save_checkpoint(tmp_path / "ck")
    assert json.loads((path / "metadata.json").read_text())["step"] == 2
    second = trainer(7)  # other weights and generators
    second.load_checkpoint(path)
    assert second.epoch == 2 and second.history == first.history
    assert second.best_metric == first.best_metric
    got.append(second.train_one_epoch(train, CLASS_WEIGHTS))
    assert got == ref
    for k, v in full.params.items():
        torch.testing.assert_close(second.params[k], v, atol=0, rtol=0)
        torch.testing.assert_close(second.eval_params[k],
                                   full.eval_params[k], atol=0, rtol=0)
    for k, v in first.best_state[0].items():
        torch.testing.assert_close(second.best_state[0][k], v, atol=0, rtol=0)


def test_trainer_checkpoint_crosses_ema_settings(tmp_path):
    """A checkpoint without an EMA loads into a trainer with one (seeded
    from the restored params) and the other way round (dropped)."""
    train, _ = data()
    base = dict(FIT_KW, num_epochs=2)
    tr0 = Trainer(_dropout_model(), TrainConfig(**dict(base, ema_decay=0.0)))
    tr0.train_one_epoch(train)
    tr0.save_checkpoint(tmp_path / "no_ema")
    tr1 = Trainer(_dropout_model(), TrainConfig(**dict(base, ema_decay=0.9)))
    tr1.load_checkpoint(tmp_path / "no_ema", train_data=train)
    for k, v in tr1.params.items():
        torch.testing.assert_close(tr1.eval_params[k], v, atol=0, rtol=0)
    assert np.isfinite(tr1.train_one_epoch(train))
    tr1.save_checkpoint(tmp_path / "with_ema")
    tr2 = Trainer(_dropout_model(), TrainConfig(**dict(base, ema_decay=0.0)))
    tr2.load_checkpoint(tmp_path / "with_ema")
    assert tr2._carry.ema_params is None
    assert np.isfinite(tr2.train_one_epoch(train))


def test_trainer_warmup_cosine_equals_fit():
    """The host-side schedule gives the scales of ``fit``'s own, and the
    epoch-at-a-time run equals ``fit``'s whole run bit for bit."""
    train, _ = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=4, ema_decay=0.0,
                             schedule="warmup_cosine", warmup_epochs=2,
                             selection="train_loss", patience=100))
    torch.manual_seed(0)
    res = t_fit.make_fit_fn(_dropout_model(), cfg, eval_names=())(
        0, train, {}, CLASS_WEIGHTS)
    torch.manual_seed(0)
    tr = Trainer(_dropout_model(), cfg, generator=0)
    scales, losses = [], []
    for _ in range(4):
        scales.append(tr._host_lr_scale())
        losses.append(tr.train_one_epoch(train, CLASS_WEIGHTS))
    assert len(set(scales)) > 2
    assert scales == res.history["lr_scale"].tolist()
    assert losses == res.history["train_loss"].tolist()


def test_trainer_fit_stops_early_and_rejects_unknown_schedule():
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=5, patience=1,
                             min_delta=2.0))
    tr = Trainer(_dropout_model(), cfg)
    hist = tr.fit(train, val, CLASS_WEIGHTS)
    # the first epoch improves on -inf, the second cannot improve by 2.0
    assert tr.stopped and len(hist["train_loss"]) == 2
    assert set(hist) >= {"train_loss", "f1", "auc", "accuracy"}
    with pytest.raises(ValueError, match="schedule"):
        Trainer(_dropout_model(),
                TrainConfig(schedule="exotic")).train_one_epoch(train)


# --- bf16 fit against the JAX package --------------------------------------------

def test_bf16_fit_matches_jax(variables, jax_runs):
    """The bf16 ``fit``: every history entry within 5e-4 of the JAX
    package's bf16 run (measured: 4.16e-4, in the train loss), while the
    port's f32 run lies farther (measured: 6.54e-4), so that an f32 run
    fails the limit; master params and statistics f32."""
    train, val = data()
    runs = {}
    for dt in ("bfloat16", "float32"):
        with exact_parity(variables):
            runs[dt] = t_fit.make_fit_fn(
                _port_model(variables),
                TrainConfig(**dict(BF16_KW, compute_dtype=dt)),
                eval_names=("val",))(0, train, {"val": val}, CLASS_WEIGHTS)
    res_j = jax_runs["bf16"]

    def gap(run):
        return max(np.abs(run.history[k].numpy() - np.asarray(v)).max()
                   for k, v in res_j.history.items())

    assert gap(runs["bfloat16"]) <= BF16_ATOL, gap(runs["bfloat16"])
    assert gap(runs["float32"]) > BF16_ATOL, gap(runs["float32"])
    for t in (*runs["bfloat16"].final_params.values(),
              *runs["bfloat16"].final_batch_stats.values()):
        assert t.dtype in (torch.float32, torch.int64)


# --- evaluate ------------------------------------------------------------------

def test_evaluate_dataset_matches_jax(variables, jax_runs):
    """``evaluate_dataset`` with the JAX ``Trainer``'s EMA params and
    statistics, given as dicts to another module, whose own weights stay
    as they were: logits within 1e-5, metrics within 1e-4;
    ``predict_probs`` is their softmax."""
    _, val = data()
    c = jax_runs["carry2"]
    carry = carry_from_jax(_port_model(variables), c)
    other = _dropout_model(3)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    metrics, out = t_eval.evaluate_dataset(other, carry.ema_params,
                                           carry.batch_stats, val)
    np.testing.assert_allclose(out.logits.numpy(), jax_runs["logits"],
                               atol=1e-5, rtol=0)
    for k, v in jax_runs["metrics"].items():
        assert metrics[k].item() == pytest.approx(v, abs=1e-4), k
    probs = t_eval.predict_probs(other, carry.ema_params, carry.batch_stats,
                                 val)
    torch.testing.assert_close(probs, torch.softmax(out.logits, -1))
    for k, v in other.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_apply_model_train_mode_leaves_statistics():
    """Train mode normalises with the batch's statistics and leaves the
    given running statistics, and the module's, untouched."""
    model = _dropout_model(4)
    model.eval()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k not in params}
    kept = {k: v.clone() for k, v in stats.items()}
    batch = _batch(6, 16, seed=8)
    train_out = t_eval.apply_model(model, params, stats, batch, train=True)
    eval_out = t_eval.apply_model(model, params, stats, batch)
    assert not torch.allclose(train_out.logits, eval_out.logits)
    for k, v in kept.items():
        assert torch.equal(stats[k], v) and torch.equal(
            model.state_dict()[k], v), k
    assert not model.training


# --- schedules -----------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-3, 3, 10, 1, 1e-6), (2e-3, 2, 5, 4, 0.0),
                                  (5e-4, 0, 6, 3, 1e-5), (1e-3, 4, 3, 2, 1e-6)])
def test_warmup_cosine_schedule_matches_optax(args):
    want = j_sched.warmup_cosine_schedule(*args)
    got = t_sched.warmup_cosine_schedule(*args)
    total = max(args[2] * args[3], args[1] * args[3]) + 4
    for step in range(-1, total):
        np.testing.assert_allclose(got(step), float(want(step)), atol=1e-7,
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_and_early_stopping_match_jax(mode):
    seq = [1.0, 0.9, 0.95, 0.95, 0.96, 0.5, 0.6, 0.7, 0.7, 0.2, 0.21, 0.22]
    kw = dict(factor=0.3, patience=1, min_lr_scale=0.05, mode=mode)
    j, t = j_sched.ReduceLROnPlateau(**kw), t_sched.ReduceLROnPlateau(**kw)
    je, te = (cls(patience=2, min_delta=0.04, mode=mode) for cls in (
        j_sched.EarlyStopping, t_sched.EarlyStopping))
    for x in seq:
        assert t.step(x) == pytest.approx(j.step(x), abs=1e-7)
        assert (t.best, t.bad_epochs) == (j.best, j.bad_epochs)
        assert te(x) == je(x)
        assert (te.best_score, te.counter) == (je.best_score, je.counter)


# --- checkpoints ---------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    model = _dropout_model(5)
    params = {k: p.detach() for k, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if k not in params}
    opt = {"step": torch.tensor(3.0), "exp_avg": {"w": torch.ones(2)}}
    path = t_ckpt.save_checkpoint(
        tmp_path / "ck", params, batch_stats=stats, opt_state=opt, step=7,
        metrics={"f1": 0.75}, metadata={"note": "x"},
        extra={"rng": torch.arange(4, dtype=torch.uint8), "flag": None})
    got = t_ckpt.load_checkpoint(path)
    assert got["step"] == 7 and got["extra"]["flag"] is None
    assert got["metadata"] == {"step": 7, "metrics": {"f1": 0.75},
                               "note": "x"}
    for k, v in {**params, **stats}.items():
        src = got["params"] if k in params else got["batch_stats"]
        assert torch.equal(src[k], v), k
    assert torch.equal(got["opt_state"]["exp_avg"]["w"], torch.ones(2))
    enc = t_ckpt.export_frozen_encoder(tmp_path / "enc", "FMRIFusionNet",
                                       params, stats, config={"h": 64},
                                       metrics={"f1": 0.5})
    meta = t_ckpt.load_checkpoint(enc)["metadata"]
    assert meta["artifact"] == "frozen_encoder"
    assert meta["model_name"] == "FMRIFusionNet" and meta["config"] == {
        "h": 64}


@pytest.mark.parametrize("scores", [[0.5, 0.9, 0.7], [None, None, None],
                                    [None, 0.2, None]])
def test_find_best_checkpoint_picks_as_jax(tmp_path, scores):
    """Fold checkpoints written by the port; the port and the JAX package
    pick the same one from their ``metadata.json``."""
    for fold, score in enumerate(scores):
        t_ckpt.save_checkpoint(
            tmp_path / f"best_trimodal_fold{fold}", {"w": torch.ones(1)},
            metrics={} if score is None else {"f1": score})
    got = t_ckpt.find_best_checkpoint(tmp_path)
    assert got == j_ckpt.find_best_checkpoint(tmp_path)
    assert got.name == ("best_trimodal_fold2" if scores[1] is None
                        else "best_trimodal_fold1")
    assert t_ckpt.find_best_checkpoint(tmp_path / "none") is None


# --- fit_resumable -------------------------------------------------------------

class Crash(Exception):
    pass


def _crashing(augment, calls):
    """``augment`` that raises at its call number ``calls + 1``."""
    count = [0]

    def wrapper(generator, batch):
        count[0] += 1
        if count[0] > calls:
            raise Crash
        return augment(generator, batch)

    return wrapper


@pytest.mark.parametrize("async_save", [False, True])
def test_fit_resumable_crash_and_resume_equal_one_run(tmp_path, async_save):
    """Three one-epoch chunks with dropout and augmentation on; a crash in
    the third, and a call again with a fresh module, equal one uninterrupted
    ``fit`` bit for bit; the chunk directories are pruned to
    ``keep_chunks``."""
    train, val = data()
    cfg = TrainConfig(**dict(FIT_KW, num_epochs=3, ema_decay=0.0))
    evals = {"val": val}
    torch.manual_seed(0)
    one = t_fit.make_fit_fn(_dropout_model(), cfg, eval_names=("val",),
                            augment=make_eeg_augment(prob=0.5))(
        0, train, evals, CLASS_WEIGHTS)
    ck = tmp_path / "ck"
    torch.manual_seed(0)
    with pytest.raises(Crash):
        fit_resumable(_dropout_model(), cfg, 0, train, evals, ck,
                      CLASS_WEIGHTS, chunk_epochs=1, async_save=async_save,
                      augment=_crashing(make_eeg_augment(prob=0.5), 4))
    # an asynchronous write in flight at the crash is waited for but not
    # marked complete
    assert latest_chunk(ck) == (0 if async_save else 1)
    torch.manual_seed(9)
    model = _dropout_model(9)
    res = fit_resumable(model, cfg, 0, train, evals, ck, CLASS_WEIGHTS,
                        chunk_epochs=1, async_save=async_save,
                        augment=make_eeg_augment(prob=0.5))
    assert latest_chunk(ck) == 2
    assert sorted(p.name for p in ck.iterdir()) == ["chunk_00001",
                                                    "chunk_00002"]
    for k, v in one.history.items():
        torch.testing.assert_close(res.history[k], v, atol=0, rtol=0, msg=k)
    for got, want in ((res.final_params, one.final_params),
                      (res.params, one.params),
                      (res.final_batch_stats, one.final_batch_stats),
                      (dict(model.named_parameters()), one.final_params)):
        for k, v in want.items():
            torch.testing.assert_close(got[k].detach(), v, atol=0, rtol=0)
    # every chunk done: a third call trains nothing and returns the run
    again = fit_resumable(_dropout_model(2), cfg, 0, train, evals, ck,
                          chunk_epochs=1)
    for k, v in one.history.items():
        torch.testing.assert_close(again.history[k], v, atol=0, rtol=0)
    assert torch.equal(again.best_epoch, one.best_epoch)


def test_fit_resumable_param_sharding_raises(tmp_path):
    """``param_sharding`` (queue A item 7b, ported) reaches every chunk's
    ``fit``: an identity layout called once a chunk, and the run equal to
    the one without it."""
    train, val = data()
    seen = []
    runs = []
    for i, hook in enumerate((None, lambda m: seen.append(m) or m)):
        model = _dropout_model()
        torch.manual_seed(0)  # the dropout masks' generator
        runs.append(fit_resumable(model, TrainConfig(**FIT_KW), 0, train,
                                  {"val": val}, tmp_path / str(i),
                                  chunk_epochs=1, param_sharding=hook))
    assert len(seen) == FIT_KW.get("num_epochs", 10)
    for k, v in runs[0].history.items():
        torch.testing.assert_close(runs[1].history[k], v, atol=0, rtol=0)
