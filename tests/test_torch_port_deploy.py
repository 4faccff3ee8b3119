"""The port's serving and deployment surface against the JAX package's.

Three seeded members of a narrow ``TriModalFusionNetV4`` (hidden 32, one
layer, two heads) at T=32 carry the same flax variables into both
packages. On the port's side every attention layer is forced onto the flash
route, so the ``mmef::flash_fwd`` operator and its vmap rule run (on the
CPU, its plain version); the JAX side takes its einsum route. The JAX runs
(a ``Predictor``, its calibration, the three ensemble reductions, and the
port's payloads through the ``Predictor``'s compiled forward) share one
module fixture.

Tolerances: probabilities within 1e-5 of JAX's (f32 softmax of logits that
agree to ~1e-7 here), votes exactly; a fitted temperature within 1e-5 of
JAX's, relative; the ensemble's vmap against a loop of members within
1e-6 (an ulp: vmap turns each member's matmuls into batched ones, summed in
another order); a checkpoint round trip and an exported program on the CPU
bit for bit;
quantized payloads array for array. ``DynamicBatcher`` rows equal the
direct call exactly; every thread wait has its own timeout.
"""

import importlib
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_eeg_fmri_tpu.core import quantize as j_quant
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu.serving import EnsemblePredictor as JEnsemble
from multimodal_eeg_fmri_tpu.serving import Predictor as JPredictor
from multimodal_eeg_fmri_tpu.serving import stack_variable_trees as j_stack
from multimodal_eeg_fmri_tpu_torch import init_weights, load_flax_variables
from multimodal_eeg_fmri_tpu_torch.convert import flax_variables_from_module
from multimodal_eeg_fmri_tpu_torch.core import checkpoint as t_ckpt
from multimodal_eeg_fmri_tpu_torch.core import quantize as t_quant
from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4 as TTri
from multimodal_eeg_fmri_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    MultiHeadAttention,
)
from multimodal_eeg_fmri_tpu_torch.report.calibration import (
    fit_temperature_ensemble,
)
from multimodal_eeg_fmri_tpu_torch.serving import (
    DynamicBatcher,
    EnsemblePredictor,
    Predictor,
    QueueFull,
    load_artifact,
)

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

TRI = dict(hidden_dim=32, num_transformer_layers=1, num_heads=2, dropout=0.0)
T, N, BATCH, K = 32, 11, 4, 3
PROB_ATOL = 1e-5
WAIT_S = 30.0       # the longest any thread of a test may wait


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def eeg_inputs(n, seed=0):
    return dict(erp=_x(n, T, 18, seed=seed), pw=_x(n, T, 75, seed=seed + 1),
                conn=_x(n, 459, seed=seed + 2))


DATA = eeg_inputs(N, seed=5)


def seeded(seed):
    """Flax variables of the narrow V4 (structure from ``eval_shape``),
    filled from a seed: kernels N(0, 1/fan_in), norm scales and fusion
    logits near 1, biases and means near 0, variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: JTri(**TRI).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        **{k: jnp.zeros(v.shape, v.dtype) for k, v in DATA.items()},
        train=False))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (r.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = {"scale": 1.0, "fusion_logits": 1.0, "temperature": 1.0}
        return (base.get(name, 0.0)
                + 0.05 * r.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def flash_forced(model):
    """Every attention layer of ``model`` on the flash route."""
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "flash"
    return model


def port_model(variables=None):
    model = flash_forced(TTri(**TRI, device="cpu"))
    if variables is None:
        return model
    return load_flax_variables(model, variables["params"],
                               variables["batch_stats"])


@pytest.fixture(scope="module")
def members():
    return [seeded(k) for k in range(K)]


@pytest.fixture(scope="module")
def payloads(members, tmp_path_factory):
    """int8 and int4 payloads of member 0 written by each package."""
    d = tmp_path_factory.mktemp("payloads")
    out = {}
    for bits in (8, 4):
        out["jax", bits] = j_quant.save_quantized(
            d / f"jax{bits}", members[0], bits=bits)
        out["port", bits] = t_quant.save_quantized(
            d / f"port{bits}",
            flax_variables_from_module(port_model(members[0])), bits=bits)
    return out


@pytest.fixture(scope="module")
def jax_runs(members, payloads):
    """Everything the JAX package serves in this file."""
    fmod = JTri(**TRI)
    # member 0's predictions with every third flipped: the calibration
    # set, on which the fitted temperature lies inside its bracket
    jp = JPredictor(fmod, members[0]["params"], members[0]["batch_stats"],
                    batch_size=BATCH)
    probs = jp(**DATA)
    y = probs.argmax(-1)
    y[::3] = 1 - y[::3]
    out = {"probs": probs, "labels": y}
    out["temperature"] = JPredictor(
        fmod, members[0]["params"], members[0]["batch_stats"],
        batch_size=BATCH).calibrated(DATA, y).temperature
    params = j_stack([m["params"] for m in members])
    stats = j_stack([m["batch_stats"] for m in members])
    for reduce in ("mean_probs", "vote", "none"):
        out[reduce] = JEnsemble(fmod, params, stats, batch_size=BATCH,
                                reduce=reduce)(**DATA)
    for bits in (8, 4):
        # the JAX package serves the port's payload: its ``load_quantized``
        # through member 0's compiled forward (``from_quantized`` is the
        # two together; a new predictor would compile the same program)
        q = j_quant.load_quantized(payloads["port", bits])
        out["quantized", bits] = np.concatenate([
            np.asarray(jp._forward(q, jax.tree.map(jnp.asarray, chunk)))[:m]
            for chunk, m in jp._pad(DATA)])
    return out


def _assert_flash_calls(calls, rows):
    """Every attention layer (ERP and PW self-attention, the
    cross-attention) went through the flash op once per padded batch of
    ``rows`` rows: 3 layers × 3 batches."""
    per_batch = calls[:3]
    assert calls == per_batch * 3, calls
    assert {c[0] for c in per_batch} == {rows}
    assert (rows, 2, T, 16) in per_batch


# --- Predictor -----------------------------------------------------------------

def test_predictor_on_the_flash_op_matches_jax(members, jax_runs,
                                               monkeypatch):
    calls = []
    real = port_attn._flash_forward

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    monkeypatch.setattr(port_attn, "_flash_forward", spy)
    got = Predictor(port_model(members[0]), batch_size=BATCH)(**DATA)
    np.testing.assert_allclose(got, jax_runs["probs"], atol=PROB_ATOL,
                               rtol=0)
    _assert_flash_calls(calls, BATCH)


def test_from_checkpoint_equals_the_live_predictor(members, tmp_path):
    model = port_model(members[0])
    params = {k: p.detach() for k, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if k not in params}
    t_ckpt.save_checkpoint(tmp_path / "ck", params, batch_stats=stats)
    loaded = Predictor.from_checkpoint(port_model(), tmp_path / "ck",
                                       batch_size=BATCH)
    np.testing.assert_array_equal(loaded(**DATA),
                                  Predictor(model, BATCH)(**DATA))


def test_calibrated_matches_jax(members, jax_runs):
    """The fitted temperature within 1e-5 of JAX's, relative, and the
    calibrated forward is softmax(z / T)."""
    base = Predictor(port_model(members[0]), batch_size=BATCH)
    cal = base.calibrated(DATA, jax_runs["labels"])
    want = jax_runs["temperature"]
    assert 0.05 < want < 50.0
    assert abs(cal.temperature - want) <= 1e-5 * want
    logits = Predictor(base.model, BATCH, return_probs=False)(**DATA)
    np.testing.assert_allclose(
        cal(**DATA), torch.softmax(torch.from_numpy(logits)
                                   / cal.temperature, -1).numpy(),
        atol=1e-6, rtol=0)


# --- EnsemblePredictor ------------------------------------------------------

@pytest.mark.parametrize("reduce", ["mean_probs", "vote", "none"])
def test_ensemble_matches_jax(members, jax_runs, reduce):
    ens = EnsemblePredictor.from_modules(
        [port_model(m) for m in members], batch_size=BATCH, reduce=reduce)
    assert ens.n_members == K
    got, want = ens(**DATA), jax_runs[reduce]
    assert got.shape == want.shape
    if reduce == "vote":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def test_ensemble_vmap_folds_members_and_equals_a_loop(members, monkeypatch):
    """One flash call per layer and batch over K·B rows, and the members'
    probabilities bit for bit those of K ``Predictor``s."""
    calls = []
    real = port_attn._flash_forward

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    models = [port_model(m) for m in members]
    loop = np.stack([Predictor(m, BATCH)(**DATA) for m in models])
    monkeypatch.setattr(port_attn, "_flash_forward", spy)
    got = EnsemblePredictor.from_modules(models, batch_size=BATCH,
                                         reduce="none")(**DATA)
    # vmap makes a member's matmuls batched ones, which the CPU sums in
    # another order: an ulp apart
    np.testing.assert_allclose(got, loop, atol=1e-6, rtol=0)
    _assert_flash_calls(calls, K * BATCH)


def test_ensemble_calibrated_is_the_shared_temperature(members, jax_runs):
    models = [port_model(m) for m in members]
    ens = EnsemblePredictor.from_modules(models, batch_size=BATCH)
    y = jax_runs["labels"]
    cal = ens.calibrated(DATA, y)
    logits = torch.stack([torch.from_numpy(
        Predictor(m, BATCH, return_probs=False)(**DATA)) for m in models])
    member_logits = ens._logits(DATA)
    torch.testing.assert_close(member_logits, logits, atol=1e-6, rtol=0)
    assert cal.temperature == float(fit_temperature_ensemble(member_logits,
                                                             y))
    np.testing.assert_allclose(
        cal(**DATA),
        torch.softmax(logits / cal.temperature, -1).mean(0).numpy(),
        atol=1e-6, rtol=0)


def test_ensemble_from_checkpoints_and_quantized(members, tmp_path):
    models = [port_model(m) for m in members]
    paths, qpaths = [], []
    for k, m in enumerate(models):
        params = {n: p.detach() for n, p in m.named_parameters()}
        stats = {n: v for n, v in m.state_dict().items() if n not in params}
        paths.append(t_ckpt.save_checkpoint(tmp_path / f"fold{k}", params,
                                            batch_stats=stats))
        qpaths.append(t_quant.save_quantized(
            tmp_path / f"q{k}", flax_variables_from_module(m)))
    want = EnsemblePredictor.from_modules(models, batch_size=BATCH)(**DATA)
    got = EnsemblePredictor.from_checkpoints(port_model(), paths,
                                             batch_size=BATCH)(**DATA)
    np.testing.assert_array_equal(got, want)
    quant = EnsemblePredictor.from_quantized(port_model(), qpaths,
                                             batch_size=BATCH)(**DATA)
    loop = np.mean([Predictor.from_quantized(port_model(), p,
                                            batch_size=BATCH)(**DATA)
                    for p in qpaths], axis=0)
    np.testing.assert_allclose(quant, loop, atol=1e-6, rtol=0)


@pytest.mark.parametrize("source", ["checkpoints", "quantized"])
def test_mixed_batch_stats_raise_naming_the_paths(members, tmp_path, source):
    model = port_model(members[0])
    params = {n: p.detach() for n, p in model.named_parameters()}
    stats = {n: v for n, v in model.state_dict().items() if n not in params}
    flax = flax_variables_from_module(model)
    paths = []
    for k in range(2):
        with_stats = k == 0
        if source == "checkpoints":
            paths.append(t_ckpt.save_checkpoint(
                tmp_path / f"f{k}", params,
                batch_stats=stats if with_stats else None))
        else:
            paths.append(t_quant.save_quantized(
                tmp_path / f"f{k}", flax if with_stats
                else {"params": flax["params"]}))
    build = (EnsemblePredictor.from_checkpoints if source == "checkpoints"
             else EnsemblePredictor.from_quantized)
    with pytest.raises(ValueError, match="batch_stats missing") as err:
        build(port_model(), paths)
    assert str(paths[1]) in str(err.value) and str(paths[0]) not in str(
        err.value)


def test_ensemble_plan_and_unknown_reduce_raise(members):
    """``plan`` is ported: a plan of one rank (a layout-only mesh, no
    process group) serves what the unplanned predictor serves, bit for
    bit, and so does a ``DynamicBatcher`` over it, which serves it as the
    unplanned batcher does (requests of 1, 3 and 2 rows one after
    another: the same calls on both); members that do not divide the
    ensemble axis raise JAX's error, as does an unknown reduction (the
    sharded predictor and its batcher: ``test_torch_port_ensemble.py``,
    ``test_torch_port_batcher_mesh.py``)."""
    from multimodal_eeg_fmri_tpu_torch.parallel import build_mesh

    models = [port_model(m) for m in members]
    for reduce in ("none", "vote", "mean_probs"):
        planned = EnsemblePredictor.from_modules(
            models, batch_size=BATCH, reduce=reduce,
            plan=build_mesh(world_size=1))
        np.testing.assert_array_equal(
            planned(**DATA), EnsemblePredictor.from_modules(
                models, batch_size=BATCH, reduce=reduce)(**DATA))
    rows = eeg_inputs(6, seed=9)
    served = []
    for ens in (planned, EnsemblePredictor.from_modules(models,
                                                        batch_size=BATCH)):
        with DynamicBatcher(ens, max_delay_ms=1.0, timeout_s=WAIT_S) as b:
            served.append([b(**{k: v[lo:hi] for k, v in rows.items()})
                           for lo, hi in ((0, 1), (1, 4), (4, 6))])
        assert (b.batches, b.rows) == (3, 6)
    for got, want in zip(*served):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="3 members not divisible by the "
                       r"mesh's ensemble axis \(2\)"):
        EnsemblePredictor.from_modules(
            models, plan=build_mesh(ensemble=2, world_size=2, rank=1))
    with pytest.raises(ValueError, match="unknown reduce"):
        EnsemblePredictor.from_modules([models[0]], reduce="max")


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (1, None, 1), (2, 2, 0)])
def test_vmap_rule_folds_any_member_axis_into_one_call(in_dims, monkeypatch):
    """A member axis in any place, or a tensor shared by all members, goes
    into one call of the flash op over K·B rows, equal to a member loop."""
    calls = []
    real = port_attn._flash_forward

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    K_, B, H, L, D = 3, 2, 2, 24, 16
    members = [torch.from_numpy(_x(K_, B, H, L, D, seed=s)) for s in (1, 2, 3)]
    args = [m[0] if d is None else m.movedim(0, d)
            for m, d in zip(members, in_dims)]
    loop = torch.stack([port_attn.flash_attention_lse(
        *(m[0] if d is None else m[i] for m, d in zip(members, in_dims)))[0]
        for i in range(K_)])
    monkeypatch.setattr(port_attn, "_flash_forward", spy)
    out, lse = torch.func.vmap(port_attn.flash_attention_lse,
                               in_dims=in_dims)(*args)
    assert calls == [(K_ * B, H, L, D)]
    assert out.shape == loop.shape and lse.shape == (K_, B, H, L)
    torch.testing.assert_close(out, loop, atol=0, rtol=0)


@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd"])
def test_flash_ops_pass_opcheck(op):
    """Schema, fake (for torch.export), autograd registration and
    dispatch of both operators, as ``torch.library.opcheck`` checks them."""
    q, k, v, g = (torch.from_numpy(_x(2, 2, 20, 16, seed=s))
                  for s in range(4))
    if op == "flash_fwd":
        fn, args = port_attn.flash_fwd_op, (q, k, v, False)
    else:
        out, lse = port_attn.flash_fwd_op(q, k, v, False)
        fn, args = port_attn.flash_bwd_op, (q, k, v, out, lse, g, None, True)
    assert set(torch.library.opcheck(fn, args).values()) == {"SUCCESS"}


@pytest.mark.parametrize("route", ["autograd", "torch.func"])
def test_gradient_under_vmap_raises(route, monkeypatch):
    """A gradient through flash attention under ``torch.func.vmap`` (by
    autograd from a vmapped forward, or ``vmap(grad(...))``) folds the
    members into one call of the flash backward over n·B rows and equals a
    loop over the members bit for bit (on the card: one K2 and one K3
    launch, ``test_torch_port_kernel.py``)."""
    q, k, v = (torch.from_numpy(_x(2, 1, 2, 20, 16, seed=s)) for s in (1, 2, 3))
    calls = []
    real = port_attn._flash_backward

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    def member_grad(i):
        qi = q[i].detach().requires_grad_()
        port_attn.flash_attention(qi, k[i], v[i]).sum().backward()
        return qi.grad

    loop = torch.stack([member_grad(i) for i in range(2)])
    monkeypatch.setattr(port_attn, "_flash_backward", spy)
    if route == "autograd":
        qv = q.clone().requires_grad_()
        torch.func.vmap(port_attn.flash_attention)(qv, k, v).sum().backward()
        got = qv.grad
    else:
        def loss(q, k, v):
            return port_attn.flash_attention(q, k, v).sum()

        got = torch.func.vmap(torch.func.grad(loss))(q, k, v)
    assert calls == [(2, 2, 20, 16)]
    torch.testing.assert_close(got, loop, atol=0, rtol=0)


# --- quantized payloads ------------------------------------------------------

def test_flax_variables_round_trip(members):
    back = flax_variables_from_module(port_model(members[0]))
    a = jax.tree_util.tree_leaves_with_path(members[0])
    b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), p


@pytest.mark.parametrize("bits", [8, 4])
def test_port_payload_equals_jax_payload(payloads, bits):
    with np.load(payloads["jax", bits]) as j, np.load(
            payloads["port", bits]) as t:
        assert sorted(j.files) == sorted(t.files)
        # the manifest's JSON may list the shapes in another order
        assert json.loads(str(t["__manifest__"])) == json.loads(
            str(j["__manifest__"]))
        for name in set(j.files) - {"__manifest__"}:
            assert j[name].dtype == t[name].dtype, name
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    assert t_quant.load_quantized(payloads["jax", bits]).keys() == {
        "params", "batch_stats"}


@pytest.mark.parametrize("bits", [8, 4])
def test_payloads_serve_across_packages(members, payloads, jax_runs, bits):
    """The port serves JAX's payload as the JAX package serves the port's,
    within the JAX tests' drift bound of the f32 model."""
    got = Predictor.from_quantized(port_model(), payloads["jax", bits],
                                   batch_size=BATCH)(**DATA)
    np.testing.assert_allclose(got, jax_runs["quantized", bits],
                               atol=PROB_ATOL, rtol=0)
    drift = np.abs(got - jax_runs["probs"]).max()
    assert drift < (0.05 if bits == 8 else 0.15), drift


def test_quantize_helpers_match_jax(members):
    params = members[0]["params"]
    jq, js = j_quant.quantize_tree(params)
    tq, ts = t_quant.quantize_tree(params)
    for a, b in zip(jax.tree.leaves(j_quant.dequantize_tree(jq, js)),
                    jax.tree.leaves(t_quant.dequantize_tree(tq, ts))):
        np.testing.assert_array_equal(a, b)
    w = _x(5, 3, 7, seed=9)
    for got, want in zip(t_quant.quantize_leaf_int4(w, 4),
                         j_quant.quantize_leaf_int4(w, 4)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="bits"):
        t_quant.save_quantized("x", members[0], bits=2)


# --- torch.export artifacts ------------------------------------------------

class TinyAttention(nn.Module):
    """One attention layer on the flash op, a BatchNorm and a head: enough
    to carry parameters, buffers and ``mmef::flash_fwd`` through an
    ensemble's export at a fraction of the V4's tracing time."""

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.attn = MultiHeadAttention(16, 2, attn_impl="flash", device="cpu")
        self.norm = BatchNorm(16, device="cpu")
        self.head = Dense(16, 2, device="cpu")
        init_weights(self, g)
        with torch.no_grad():
            self.norm.running_mean.uniform_(-0.5, 0.5, generator=g)
            self.norm.running_var.uniform_(0.5, 1.5, generator=g)

    def forward(self, x):
        y, _ = self.attn(x, x, x)
        return ModelOutput(logits=self.head(self.norm(y.mean(1))))


@pytest.mark.parametrize("kind", ["predictor", "ensemble"])
def test_export_artifact_round_trip(members, tmp_path, kind):
    """The V4's predictor, and an ensemble of three small attention models,
    exported, loaded again without model code and served bit for bit; the
    program calls the flash op (the ensemble's once per layer, folded)."""
    if kind == "predictor":
        served = Predictor(port_model(members[0]), BATCH)
        example = {k: v[:BATCH] for k, v in DATA.items()}
    else:
        served = EnsemblePredictor.from_modules(
            [TinyAttention(k) for k in range(K)], batch_size=BATCH)
        example = {"x": _x(BATCH, 20, 16, seed=4)}
    path = tmp_path / f"{kind}.pt2"
    blob = served.export_artifact({**example, "label": np.zeros(BATCH)},
                                  path)
    assert path.stat().st_size == len(blob) > 1000
    program = torch.export.load(path)
    flash = [n for n in program.graph.nodes
             if n.op == "call_function" and "mmef.flash_fwd" in str(n.target)]
    rows = BATCH if kind == "predictor" else K * BATCH
    assert flash and all(n.args[0].meta["val"].shape[0] == rows
                         for n in flash)
    np.testing.assert_array_equal(load_artifact(path)(**example),
                                  served(**example))


# --- DynamicBatcher ----------------------------------------------------------

def _threads(fn, n):
    """Run ``fn(i)`` on ``n`` threads; re-raise the first exception any of
    them raised once all have joined."""
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- handed to the test
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a request thread hung"
    if errors:
        raise errors[0]


@pytest.fixture(scope="module")
def predictor():
    return Predictor(flash_forced(init_weights(
        TTri(**TRI, device="cpu"), torch.Generator().manual_seed(0))),
        batch_size=8)


def test_batcher_coalesces_concurrent_requests(predictor):
    rows = eeg_inputs(16, seed=7)
    direct = predictor(**rows)
    out = {}
    with DynamicBatcher(predictor, max_delay_ms=50.0, max_batch=8,
                        timeout_s=WAIT_S) as b:
        _threads(lambda i: out.__setitem__(
            i, b(**{k: v[i:i + 1] for k, v in rows.items()})), 16)
        assert b.rows == 16 and b.batches < 16
    for i in range(16):
        np.testing.assert_array_equal(out[i], direct[i:i + 1])


def test_batcher_multirow_deadline_and_key_sets(predictor):
    rows = eeg_inputs(3, seed=8)
    with DynamicBatcher(predictor, max_delay_ms=1.0,
                        timeout_s=WAIT_S) as b:
        # alone, three rows are flushed at the deadline, not at max_batch
        np.testing.assert_array_equal(b(**rows), predictor(**rows))
        assert (b.batches, b.rows) == (1, 3)
    seen = []

    def echo(**inputs):
        seen.append(sorted(inputs))
        return np.concatenate([v for _, v in sorted(inputs.items())], 1)

    out = {}
    with DynamicBatcher(echo, max_delay_ms=100.0, max_batch=8,
                        timeout_s=WAIT_S) as b:
        keys = ("a", "b")
        _threads(lambda i: out.__setitem__(i, b(**{keys[i % 2]: np.full(
            (1, 1), float(i))})), 4)
    # key sets never mix: each call saw one of them
    assert all(len(keys) == 1 for keys in seen), seen
    for i in range(4):
        np.testing.assert_array_equal(out[i], [[float(i)]])


def test_batcher_delivers_errors_and_closes():
    def failing(**inputs):
        raise RuntimeError("device fault")

    b = DynamicBatcher(failing, max_delay_ms=1.0, timeout_s=WAIT_S)
    with pytest.raises(RuntimeError, match="device fault"):
        b(x=np.zeros((1, 1)))
    b.close()
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b(x=np.zeros((1, 1)))
    with pytest.raises(ValueError, match="empty"):
        DynamicBatcher(failing)(label=np.zeros(1))


def test_batcher_backpressure_bounds_the_queue():
    """A burst far beyond the flush rate: the pending rows never exceed
    ``max_queue``, overflow gets ``QueueFull`` at once, accepted rows are
    right; a violated bound inside a thread fails the test."""
    max_queue = 4

    def slow(**inputs):
        time.sleep(0.05)
        return np.asarray(inputs["x"]) * 2.0

    served, rejected = {}, []
    with DynamicBatcher(slow, max_delay_ms=1.0, max_batch=4,
                        max_queue=max_queue, timeout_s=WAIT_S) as b:
        def one(i):
            try:
                served[i] = b(x=np.asarray([[float(i)]]))
            except QueueFull:
                rejected.append(i)
            with b._cv:
                pending = sum(r.n for _, r in b._queue)
            assert pending <= max_queue, pending

        _threads(one, 32)
        assert b.rejected == len(rejected) > 0
    assert len(served) + len(rejected) == 32 and served
    for i, out in served.items():
        np.testing.assert_array_equal(out, [[2.0 * i]])


def test_batcher_timeout_withdraws_a_wedged_request():
    release = threading.Event()

    def wedged(**inputs):
        release.wait(WAIT_S)
        return np.asarray(inputs["x"])

    b = DynamicBatcher(wedged, max_delay_ms=1.0, max_batch=2, timeout_s=0.2)
    try:
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="timed out"):
            b(x=np.zeros((1, 1), np.float32))
        assert time.perf_counter() - t0 < 5.0
        with pytest.raises(TimeoutError):
            b(x=np.zeros((1, 1), np.float32))
        with b._cv:
            assert not b._queue
    finally:
        release.set()
        b.close()


def test_batcher_rejects_per_member_output_and_wraps_a_reduction(members):
    models = [port_model(m) for m in members]
    with pytest.raises(ValueError, match="reduce='none'"):
        DynamicBatcher(EnsemblePredictor.from_modules(models, reduce="none"))
    ens = EnsemblePredictor.from_modules(models, batch_size=BATCH)
    rows = eeg_inputs(6, seed=9)
    out = {}
    with DynamicBatcher(ens, max_delay_ms=50.0, timeout_s=WAIT_S) as b:
        _threads(lambda i: out.__setitem__(
            i, b(**{k: v[i:i + 1] for k, v in rows.items()})), 6)
    np.testing.assert_allclose(np.concatenate([out[i] for i in range(6)]),
                               ens(**rows), atol=1e-6, rtol=0)
    for bad in (dict(max_delay_ms=-1), dict(max_queue=0),
                dict(timeout_s=0)):
        with pytest.raises(ValueError):
            DynamicBatcher(ens, **bad)
