"""The port's ``LongContextClassifier`` against the JAX package's.

The same seeded flax variables (``load_flax_variables``) in both, at narrow
widths (hidden 16-32, 1-2 layers, 2 heads, 4 experts, T ≤ 64):

- the eval forward on the einsum route, with ``patch`` 1 and 4, with and
  without the MoE FFN, within 1e-5, and a train-mode loss (plus the sown
  aux losses) and gradients within 1e-4 of the largest; the ``T % patch``
  error;
- the flash route forced at small T (``attn_impl="flash"``): the port's
  plain kernels against the JAX package's flash kernel in interpret mode;
- ``remat`` against no remat on the port, with and without MoE, through
  ``TrainStep``: the loss equal, the gradients within 1e-6, and K1 run
  twice a block;
- ``fit`` against the JAX package's ``make_fit_fn`` with MoE (aux included)
  and with ``grad_accum=2``: loss histories within 1e-5; one bf16 step
  against the JAX package's bf16 train forward compiled without excess
  precision (as ``test_torch_port_mixed_precision.py`` holds the bf16
  logits): the task loss within 6e-3 relative and the aux loss, from the
  f32 router, within 1e-4 relative;
- a ``Predictor``'s logits within 1e-5 of the JAX package's;
- ``expert_axis`` raising, naming queue A item 7b; the ring options
  building (the ring itself: ``test_torch_port_ring_fit.py``).

The JAX fits are module-scoped, compiled in parallel threads.
"""

import contextlib
import importlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_models import _to_jax, _to_torch, _x
from test_torch_port_moe import _grads_close, _sown, seeded_variables

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.models import long_context as j_lc
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu.serving import Predictor as JPredictor
from multimodal_eeg_fmri_tpu_torch import Predictor, load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import long_context as t_lc
from multimodal_eeg_fmri_tpu_torch.ops import losses as t_losses
from multimodal_eeg_fmri_tpu_torch.ops import moe as t_moe

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
t_fit = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.fit")
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

FWD_ATOL = 1e-5
REMAT_ATOL = 1e-6
HISTORY_ATOL = 1e-5
BF16_RTOL = 6e-3          # test_torch_port_mixed_precision.py's LOGITS_RTOL
AUX_BF16_RTOL = 1e-4
MOE = dict(num_experts=4, moe_top_k=2)
CW = np.array([0.8, 1.3], np.float32)

# (keyword arguments of both models, T)
CASES = {
    "dense": (dict(hidden_dim=32, num_layers=2, num_heads=2), 48),
    "patch4": (dict(hidden_dim=32, num_layers=1, num_heads=2, patch=4), 64),
    "moe": (dict(hidden_dim=16, num_layers=2, num_heads=2, **MOE), 32),
    "moe_patch2_top1": (dict(hidden_dim=16, num_layers=1, num_heads=2,
                             patch=2, num_experts=4), 32),
}


def _pair(kw, T, B=4, seed=0, **port_kw):
    """(flax model, port model with the same seeded weights, variables,
    inputs)."""
    fmod = j_lc.LongContextClassifier(**kw)
    inputs = dict(erp=_x(B, T, 18, seed=seed))
    variables = seeded_variables(fmod, kwargs=inputs, seed=seed)
    tmod = t_lc.LongContextClassifier(**kw, **port_kw, device="cpu")
    load_flax_variables(tmod, variables["params"])
    return fmod, tmod, variables, inputs


def _weighted_ce_j(logits, B):
    label, w = np.arange(B) % 2, np.linspace(0.5, 1.5, B, dtype=np.float32)
    return j_losses.weighted_cross_entropy(
        logits, jnp.asarray(label), jnp.asarray(CW), jnp.asarray(w))


def _weighted_ce_t(logits, B):
    label, w = np.arange(B) % 2, np.linspace(0.5, 1.5, B, dtype=np.float32)
    return t_losses.weighted_cross_entropy(
        logits, torch.from_numpy(label), torch.from_numpy(CW),
        torch.from_numpy(w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_long_context_matches_jax(name):
    """Eval forward (logits and features) within 1e-5; a train-mode
    weighted CE plus the aux losses within 1e-5, every weight and input
    gradient within 1e-4 of the largest."""
    kw, T = CASES[name]
    fmod, tmod, variables, inputs = _pair(kw, T)
    ref = jax.jit(fmod.apply)(variables, **_to_jax(inputs))
    with torch.no_grad():
        out = tmod.eval()(**_to_torch(inputs))
    assert out.fusion_weights is None and out.attn_weights is None
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL,
                                   rtol=0)

    def loss_j(params, erp):
        o, mut = fmod.apply({"params": params}, erp=erp, train=True,
                            mutable=["losses"])
        return _weighted_ce_j(o.logits, 4) + _sown(mut)

    loss_w, (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        variables["params"], jnp.asarray(inputs["erp"]))
    erp = torch.from_numpy(inputs["erp"]).requires_grad_()
    with t_moe.collect_aux_losses() as sink:
        o = tmod.train()(erp=erp)
    assert len(sink) == (kw["num_layers"] if "num_experts" in kw else 0)
    loss_t = _weighted_ce_t(o.logits, 4)
    if sink:
        loss_t = loss_t + t_moe.total_aux_loss(sink)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_w), atol=FWD_ATOL,
                               rtol=0)
    want = load_flax_variables(
        t_lc.LongContextClassifier(**kw, device="cpu"),
        jax.tree.map(np.asarray, gp)).state_dict()
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    _grads_close({**got, "erp": erp.grad.numpy()},
                 {**{k: want[k].numpy() for k in got}, "erp": gx})


def test_patch_must_divide_T():
    fmod, tmod, variables, _ = _pair(CASES["patch4"][0], 64)
    erp = _x(2, 62, 18)
    with pytest.raises(ValueError, match="not divisible by patch=4"):
        fmod.apply(variables, erp=jnp.asarray(erp))
    with pytest.raises(ValueError, match="not divisible by patch=4"):
        tmod(erp=torch.from_numpy(erp))


@pytest.fixture
def flash_calls(monkeypatch):
    """The JAX flash kernel in interpret mode; flash forwards counted on
    both sides."""
    calls = {"jax": 0, "port": 0}
    jax_flash_attention = jax_attn.flash_attention
    port_flash_forward = port_attn._flash_forward

    def jax_flash(*a, **kw):
        calls["jax"] += 1
        return jax_flash_attention(*a, interpret=True, **kw)

    def port_flash(*a, **kw):
        calls["port"] += 1
        return port_flash_forward(*a, **kw)

    monkeypatch.setattr(jax_attn, "flash_attention", jax_flash)
    monkeypatch.setattr(port_attn, "_flash_forward", port_flash)
    return calls


@pytest.mark.parametrize("moe", [False, True])
def test_flash_route_matches_jax(flash_calls, moe):
    """``attn_impl="flash"`` at T=48 and D=16 (hidden 32 over 2 heads): the
    port's plain K1-K3 against the JAX flash kernel in interpret mode, the
    eval forward within 1e-5 and the input gradient of a train-mode loss
    within 1e-4 of its largest; one flash forward a layer on each side."""
    kw = dict(hidden_dim=32, num_layers=2, num_heads=2, attn_impl="flash",
              **(MOE if moe else {}))
    fmod, tmod, variables, inputs = _pair(kw, 48)
    flash_calls.update(jax=0, port=0)
    ref = jax.jit(fmod.apply)(variables, **_to_jax(inputs))
    with torch.no_grad():
        out = tmod.eval()(**_to_torch(inputs))
    assert flash_calls == {"jax": 2, "port": 2}
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=FWD_ATOL, rtol=0)

    def loss_j(erp):
        o, mut = fmod.apply(variables, erp=erp, train=True,
                            mutable=["losses"])
        return _weighted_ce_j(o.logits, 4) + _sown(mut)

    gx = jax.jit(jax.grad(loss_j))(jnp.asarray(inputs["erp"]))
    erp = torch.from_numpy(inputs["erp"]).requires_grad_()
    with t_moe.collect_aux_losses() as sink:
        o = tmod.train()(erp=erp)
    loss = _weighted_ce_t(o.logits, 4)
    if sink:
        loss = loss + t_moe.total_aux_loss(sink)
    loss.backward()
    _grads_close({"erp": erp.grad.numpy()}, {"erp": np.asarray(gx)})


@pytest.mark.parametrize("moe", [False, True])
def test_remat_matches_no_remat(monkeypatch, moe):
    """``TrainStep``'s loss (task + aux) and gradients with ``remat=True``
    against the same weights without it, on the flash route (T=48): the
    loss equal, every gradient within 1e-6; each block's K1 runs again in
    the backward (4 forwards at 2 layers, against 2), and the aux losses
    are counted once."""
    kw = dict(hidden_dim=16, num_layers=2, num_heads=2, attn_impl="flash",
              **(MOE if moe else {}))
    _, plain, variables, inputs = _pair(kw, 48, B=8)
    rematted = load_flax_variables(
        t_lc.LongContextClassifier(**kw, remat=True, device="cpu"),
        variables["params"])
    batch = {"erp": torch.from_numpy(inputs["erp"]),
             "label": torch.arange(8) % 2, "weight": torch.ones(8)}
    calls = []
    real = port_attn._flash_forward
    monkeypatch.setattr(port_attn, "_flash_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = {}
    for name, model in (("plain", plain), ("remat", rematted)):
        calls.clear()
        step = t_fit.TrainStep(model, TrainConfig(loss="weighted_ce"))
        task, aux = step.losses(batch, torch.from_numpy(CW))
        loss = task if aux is None else task + aux
        loss.backward()
        runs[name] = (loss.item(), None if aux is None else aux.item(),
                      {k: p.grad.clone() for k, p in model.named_parameters()},
                      len(calls))
    assert runs["plain"][3] == 2 and runs["remat"][3] == 4
    assert runs["remat"][:2] == runs["plain"][:2]
    assert (runs["plain"][1] is not None) == moe
    for k, g in runs["plain"][2].items():
        np.testing.assert_allclose(runs["remat"][2][k].numpy(), g.numpy(),
                                   atol=REMAT_ATOL, rtol=0, err_msg=k)


# --- fit against the JAX package's make_fit_fn -----------------------------

FIT_MODEL = dict(hidden_dim=16, num_layers=1, num_heads=2, **MOE)
FIT_T, N_TRAIN, N_VAL = 32, 16, 8
FIT_KW = dict(batch_size=8, num_epochs=3, learning_rate=3e-3,
              weight_decay=1e-2, grad_clip=1.0, loss="weighted_ce",
              selection="val")
FIT_CONFIGS = {"accum1": FIT_KW, "accum2": dict(FIT_KW, grad_accum=2)}


def _cohort(n, seed):
    """n subjects of T=32 raw frames, class 1 with a shifted channel mean;
    row weights in [0.5, 1.5], so that two microbatches carry unequal
    shares of a batch's weight (the aux loss is divided by k, not scaled
    by a share)."""
    label = np.arange(n) % 2
    erp = _x(n, FIT_T, 18, seed=seed) + 0.5 * label[:, None, None]
    weight = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    return dict(erp=erp.astype(np.float32), label=label.astype(np.int32),
                weight=weight.astype(np.float32))


@contextlib.contextmanager
def exact_parity(variables):
    """flax's ``init`` returns ``variables``; both shuffles are the
    identity (the model has no dropout)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_lc.LongContextClassifier, "init",
                   lambda self, *a, **k: jax.tree.map(jnp.asarray, variables))
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
        mp.setattr(torch, "randperm",
                   lambda n, generator=None, device=None: torch.arange(
                       n, device=device))
        yield


@pytest.fixture(scope="module")
def fit_variables():
    return seeded_variables(j_lc.LongContextClassifier(**FIT_MODEL),
                            kwargs=dict(erp=_x(8, FIT_T, 18)), seed=5)


@pytest.fixture(scope="module")
def jax_fits(fit_variables):
    """The JAX ``fit`` of each config, and the task and aux losses of the
    bf16 train forward compiled without excess precision."""
    train, val = _cohort(N_TRAIN, 1), _cohort(N_VAL, 2)
    args = (jax.random.key(0), jax.tree.map(jnp.asarray, train),
            {"val": jax.tree.map(jnp.asarray, val)}, jnp.asarray(CW))
    fmod = j_lc.LongContextClassifier(**FIT_MODEL)

    def bf16_losses(params, erp):
        bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        o, mut = fmod.apply({"params": bf}, erp=erp.astype(jnp.bfloat16),
                            train=True, mutable=["losses"])
        task = j_losses.weighted_cross_entropy(
            o.logits, jnp.asarray(train["label"][:8]), jnp.asarray(CW),
            jnp.asarray(train["weight"][:8]))
        return task, _sown(mut)

    bf16_args = (fit_variables["params"], jnp.asarray(train["erp"][:8]))
    with exact_parity(fit_variables):
        lowered = [jax.jit(j_fit.make_fit_fn(
            fmod, JTrainConfig(**cfg), eval_names=("val",))).lower(*args)
            for cfg in FIT_CONFIGS.values()]
        lowered.append(jax.jit(bf16_losses).lower(*bf16_args))
    options = [None] * len(FIT_CONFIGS) + [
        {"xla_allow_excess_precision": False}]
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(
            lambda lo: lo[0].compile(compiler_options=lo[1]),
            zip(lowered, options)))
    out = {name: fn(*args) for name, fn in zip(FIT_CONFIGS, compiled)}
    out["bf16"] = compiled[-1](*bf16_args)
    return train, val, out


def _port_model(variables, **kw):
    return load_flax_variables(
        t_lc.LongContextClassifier(**FIT_MODEL, **kw, device="cpu"),
        variables["params"])


@pytest.mark.parametrize("name", sorted(FIT_CONFIGS))
def test_fit_matches_jax(fit_variables, jax_fits, name):
    """The port's ``fit`` of a MoE long-context model: the train loss
    (task + aux, or Σ_k scale_k·task_k + aux_k/k over two microbatches)
    and every validation metric within 1e-5 of the JAX package's,
    epoch for epoch."""
    train, val, runs = jax_fits
    with exact_parity(fit_variables):
        res = t_fit.make_fit_fn(_port_model(fit_variables),
                                TrainConfig(**FIT_CONFIGS[name]),
                                eval_names=("val",))(0, train, {"val": val},
                                                     CW)
    want = runs[name]
    assert set(res.history) == set(want.history)
    for k, v in want.history.items():
        np.testing.assert_allclose(res.history[k].numpy(), np.asarray(v),
                                   atol=HISTORY_ATOL, rtol=0, err_msg=k)
    assert int(res.best_epoch) == int(want.best_epoch)


def test_fit_loss_adds_the_aux_term(fit_variables):
    """The step's loss is the task loss plus the block's 0.01·aux; with
    two microbatches, each microbatch's aux divided by 2; an eval forward
    between two steps adds nothing and leaves no aux behind."""
    train = {k: torch.from_numpy(v[:8]) for k, v in _cohort(8, 1).items()}
    cw = torch.from_numpy(CW)
    model = _port_model(fit_variables)
    step = t_fit.TrainStep(model, TrainConfig(**FIT_KW))
    seen = []
    hook = model.block_0.moe.register_forward_hook(
        lambda m, args, out: seen.append(args[0].detach()))
    task, aux = step.losses(train, cw)
    hook.remove()
    with torch.no_grad():
        *_, raw = model.block_0.moe.routing(seen[0])
    assert aux.item() == pytest.approx(0.01 * raw.item(), rel=1e-6)
    assert step.loss(train, cw).item() == pytest.approx(
        (task + aux).item(), abs=1e-7)
    with torch.no_grad():
        model.eval()(erp=train["erp"])
    assert step.loss(train, cw).item() == pytest.approx(
        (task + aux).item(), abs=1e-7)

    accum = t_fit.TrainStep(model, TrainConfig(**FIT_CONFIGS["accum2"]))
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in train.items()}
              for i in range(2)]
    parts = [accum.losses(h, cw) for h in halves]
    # weighted CE's weights: the rows' times their class weights
    w = train["weight"] * cw[train["label"].long()]
    shares = [w[:4].sum() / w.sum(), w[4:].sum() / w.sum()]
    assert abs(shares[0].item() - 0.5) > 0.01
    want = sum(sh * t + a / 2 for sh, (t, a) in zip(shares, parts))
    got = accum.objective(train, cw, backward=False)
    assert got.item() == pytest.approx(want.item(), abs=1e-7)


def test_bf16_step_matches_jax(fit_variables, jax_fits):
    """One bf16 train-mode forward (``compute_dtype="bfloat16"``): the
    task loss within 6e-3 relative of the JAX package's, and the aux loss,
    from the f32 router on bf16-rounded weights, within 1e-4 relative."""
    train, _, runs = jax_fits
    task_j, aux_j = (float(v) for v in runs["bf16"])
    batch = {k: torch.from_numpy(v[:8]) for k, v in train.items()}
    step = t_fit.TrainStep(_port_model(fit_variables),
                           TrainConfig(**FIT_KW, compute_dtype="bfloat16"))
    task, aux = step.losses(batch, torch.from_numpy(CW))
    assert aux.dtype == torch.float32
    assert abs(task.item() - task_j) <= BF16_RTOL * abs(task_j), (
        task.item(), task_j)
    assert abs(aux.item() - aux_j) <= AUX_BF16_RTOL * abs(aux_j), (
        aux.item(), aux_j)


def test_predictor_matches_jax():
    """``Predictor(batch_size=4)`` of a MoE long-context model over 6 rows
    (a padded last batch): logits within 1e-5 of the JAX package's
    ``Predictor``. The experts' capacity follows the tokens of a batch, so
    the batching is part of the function."""
    fmod, tmod, variables, inputs = _pair(CASES["moe"][0], 32, B=6)
    want = JPredictor(fmod, variables["params"], batch_size=4,
                      return_probs=False)(**inputs)
    got = Predictor(tmod, batch_size=4, return_probs=False)(**inputs)
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL, rtol=0)
    whole = jax.jit(fmod.apply)(variables, **_to_jax(inputs)).logits
    assert np.abs(got - np.asarray(whole)).max() > 1e-3


@pytest.mark.parametrize("kw", [
    dict(attn_impl="ring"), dict(mesh=object()), dict(head_axis="model"),
    dict(expert_axis="expert"), dict(ring_chunk_impl="flash")])
def test_parallel_options_name_queue_a_item_7(kw):
    """The parallel options build: expert parallelism (item 7b) on a
    layout-only (data 1 × expert 1) mesh runs a forward with its MoE
    blocks; the sequence-parallel options build, and the ring route without
    a mesh raises at its first forward."""
    if "expert_axis" in kw:
        from multimodal_eeg_fmri_tpu_torch.parallel import Mesh

        mesh = Mesh(np.zeros((1, 1), np.int64), ("data", "expert"))
        model = t_lc.LongContextClassifier(**kw, mesh=mesh, num_experts=2,
                                           hidden_dim=16, num_layers=1,
                                           device="cpu")
        assert model.block_0.moe.expert_axis == "expert"
        with torch.no_grad():
            out = model.eval()(erp=torch.zeros(2, 8, 18))
        assert out.logits.shape == (2, 2)
        return
    model = t_lc.LongContextClassifier(**kw, device="cpu")
    if kw.get("attn_impl") == "ring":
        with pytest.raises(ValueError, match="requires a mesh"):
            model(erp=torch.zeros(1, 8, 18))
