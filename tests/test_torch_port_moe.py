"""The port's Mixture-of-Experts FFN against the JAX package's.

``top_k_routing`` on the same f32 logits (k ∈ {1, 2}, capacity below and
above the token count, tied logits); ``MoEFFN`` on its identical-expert
oracles; ``MoEFFN``, ``TransformerBlock(num_experts=4)`` and
``TriModalFusionNetV4(num_experts=4, moe_top_k=2)`` with the same seeded
flax variables (``load_flax_variables``): the eval forward within 1e-5, and
in training mode the loss with the sown aux losses and every gradient
within 1e-4 of the largest; ``init_weights``' expert fan-in. The layer's
index route against the dense (S, E, C) products built from
``top_k_routing`` (the dispatched rows bit for bit, the rest within 1e-6
of the largest), with no dense tensor and no accumulation by index on its
path, and under vmap, export and checkpoint. Widths are narrow: D =
16-32, 4 experts, ff 32-64, T ≤ 32, one layer.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_cv import flax_dropout_off
from test_torch_port_models import _to_jax, _to_torch, _x
from test_torch_port_zoo import _gate_dropout_off

from multimodal_eeg_fmri_tpu.models import eeg as j_eeg
from multimodal_eeg_fmri_tpu.models import layers as j_layers
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu.ops import moe as j_moe
from multimodal_eeg_fmri_tpu_torch import init_weights, load_flax_variables
from multimodal_eeg_fmri_tpu_torch.convert import flax_variables_from_module
from multimodal_eeg_fmri_tpu_torch.models import eeg as t_eeg
from multimodal_eeg_fmri_tpu_torch.models import layers as t_layers
from multimodal_eeg_fmri_tpu_torch.ops import losses as t_losses
from multimodal_eeg_fmri_tpu_torch.ops import moe as t_moe
from multimodal_eeg_fmri_tpu_torch.parallel import Mesh

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

ROUTE_ATOL = 1e-6
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4          # of the largest gradient


def seeded_variables(fmod, args=(), kwargs=None, seed=0):
    """Flax variables of ``fmod`` in its ``init`` layout (``eval_shape``,
    no compile), from a seed: kernels and the experts' ``w1``/``w2``
    N(0, 1/fan_in) with flax's fan-in (the expert axis counted), biases and
    running means near 0, running variances in [0.5, 1.5], every other leaf
    near 1."""
    shapes = jax.eval_shape(fmod.init, jax.random.key(0), *_to_jax(args),
                            **_to_jax(kwargs or {}))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name, n = path[-1].key, r.standard_normal(s.shape)
        if name in ("kernel", "w1", "w2"):
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("bias", "mean", "b1", "b2"):
            v = 0.1 * n
        elif name == "var":
            v = r.uniform(0.5, 1.5, s.shape)
        else:
            v = 1.0 + 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _logits(S, E, seed=0):
    return _x(S, E, seed=seed)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [5, 64, 200])
def test_top_k_routing_matches_jax(k, capacity):
    """64 tokens over 4 experts: a capacity of 5 drops tokens, 64 and 200
    (above S) drop none; dispatch exactly, combine and aux within 1e-6."""
    logits = _logits(64, 4, seed=k)
    want = jax.jit(j_moe.top_k_routing, static_argnums=(1, 2))(
        jnp.asarray(logits), k, capacity)
    got = t_moe.top_k_routing(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROUTE_ATOL,
                                   rtol=0)
    kept = got[0].sum().item()
    assert kept == (min(64 * k, 4 * capacity) if capacity == 5
                    else 64 * k)


TIED = {
    "all_equal": (np.zeros((3, 4), np.float32),
                  {1: [[1, 0, 0, 0]] * 3, 2: [[1, 1, 0, 0]] * 3}),
    "some_equal": (np.array([[1.0, 2.0, 2.0, 2.0], [3.0, 3.0, 0.0, 3.0],
                             [0.5, 0.5, 0.5, 0.5]], np.float32),
                   {1: [[0, 1, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]],
                    2: [[0, 1, 1, 0], [1, 1, 0, 0], [1, 1, 0, 0]]}),
}


@pytest.mark.parametrize("case", sorted(TIED))
@pytest.mark.parametrize("k", [1, 2])
def test_tied_logits_route_to_the_lowest_index(case, k):
    """``jax.lax.top_k`` takes the lowest expert index among ties;
    ``torch.topk`` gives no such order (on the CPU it took the highest)."""
    logits, experts = TIED[case]
    want = j_moe.top_k_routing(jnp.asarray(logits), k, 3)
    got = t_moe.top_k_routing(torch.from_numpy(logits), k, 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=ROUTE_ATOL, rtol=0)
    assert got[0].sum(-1).tolist() == experts[k]


def _identical_experts(moe: t_moe.MoEFFN, seed=0):
    """Give every expert of ``moe`` one FFN's weights; returns the FFN."""
    r = np.random.default_rng(seed)
    E, D, ff = moe.w1.shape
    w1 = torch.from_numpy(_x(D, ff, seed=seed) / np.float32(np.sqrt(D)))
    w2 = torch.from_numpy(_x(ff, D, seed=seed + 1) / np.float32(np.sqrt(ff)))
    b1 = torch.from_numpy(0.1 * r.standard_normal(ff).astype(np.float32))
    b2 = torch.from_numpy(0.1 * r.standard_normal(D).astype(np.float32))
    with torch.no_grad():
        moe.w1.copy_(w1.expand(E, D, ff))
        moe.w2.copy_(w2.expand(E, ff, D))
        moe.b1.copy_(b1.expand(E, ff))
        moe.b2.copy_(b2.expand(E, D))
    return lambda x: t_layers.gelu(x @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("k", [1, 2])
def test_identical_experts_reduce_to_the_dense_ffn(k):
    """With identical experts and room for every token (capacity factor
    E): k = 2 is the dense FFN (renormalised gates sum to 1), k = 1 the
    FFN scaled by the top router probability (the Switch gate)."""
    moe = t_moe.MoEFFN(16, 4, 32, top_k=k, capacity_factor=4.0,
                       device="cpu").eval()
    ffn = _identical_experts(moe)
    x = torch.from_numpy(_x(2, 12, 16, seed=3))
    with torch.no_grad():
        got = moe(x)
        want = ffn(x)
        if k == 1:
            logits = x.reshape(-1, 16) @ moe.router.weight.T
            want = want * torch.softmax(logits, -1).amax(-1).view(2, 12, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_ATOL,
                               rtol=0)


def test_capacity_is_the_jax_formula():
    for S, E, cf in [(16384, 4, 2.0), (7, 3, 1.0), (5, 4, 0.1), (10, 2, 9.0),
                     (100, 3, 1.25)]:
        moe = t_moe.MoEFFN(8, E, capacity_factor=cf, device="cpu")
        want = min(max(1, int(-(-S * cf // E))), S)
        assert moe.capacity(S) == want, (S, E, cf)


# capacity factor, tied logits, (e0, held): the experts this rank holds
INDEX_CASES = {
    "roomy": (4.0, False, (0, 4)),
    "tight": (0.5, False, (0, 4)),
    "tied": (1.0, True, (0, 4)),
    "slice": (1.0, False, (1, 2)),
}
INDEX_ATOL = 1e-6         # of the largest


def _dense_route(layer, params, x, e0, held):
    """The layer's output and aux loss on the dense route: the (S, E, C)
    tensors of ``top_k_routing`` cut to experts [e0, e0 + held) and
    contracted, then the expert stage as the layer runs it."""
    B, T, D = x.shape
    xs = x.reshape(B * T, D)
    logits = torch.nn.functional.linear(xs, params["router.weight"])
    dispatch, combine, aux = t_moe.top_k_routing(
        logits, layer.top_k, layer.capacity(B * T))
    dispatch = dispatch[:, e0:e0 + held]
    combine = combine[:, e0:e0 + held]
    xe = torch.einsum("sec,sd->ecd", dispatch, xs)
    h = t_moe.gelu(torch.einsum("ecd,edf->ecf", xe, params["w1"])
                   + params["b1"][:, None, :])
    ye = (torch.einsum("ecf,efd->ecd", h, params["w2"])
          + params["b2"][:, None, :])
    y = torch.einsum("sec,ecd->sd", combine, ye)
    return xe, y.reshape(B, T, D), layer.aux_weight * aux


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
@pytest.mark.parametrize("k", [1, 2])
def test_index_route_matches_the_dense_route(case, k, monkeypatch):
    """``MoEFFN``'s index route against the dense (S, E, C) products built
    here from ``top_k_routing``: 48 tokens over 4 experts, a roomy
    capacity, a tight one that drops pairs, tied logits (experts 0 and 1,
    2 and 3 score alike), and a rank holding experts 1-2 of 4 as expert
    parallelism lays them out. The dispatched (E, C, D) rows bit for bit;
    y, the aux loss and the gradients of x, the router, w1, b1, w2 and b2
    within 1e-6 of their largest."""
    cf, tied, (e0, held) = INDEX_CASES[case]
    E, D = 4, 16
    torch.manual_seed(k)
    # a one-rank expert axis: its psum is the identity
    one = Mesh(np.zeros((1,), np.int64), ("expert",))
    layer = t_moe.MoEFFN(D, E, 32, top_k=k, capacity_factor=cf, mesh=one,
                         expert_axis="expert", device="cpu").train()
    with torch.no_grad():
        layer.b1.normal_(0, 0.1)
        layer.b2.normal_(0, 0.1)
        if tied:
            layer.router.weight[1] = layer.router.weight[0]
            layer.router.weight[3] = layer.router.weight[2]
        # this rank's experts, as ``parallel.expert`` shards them
        for name in ("w1", "b1", "w2", "b2"):
            setattr(layer, name, torch.nn.Parameter(
                getattr(layer, name)[e0:e0 + held].clone()))
    x = torch.from_numpy(_x(2, 24, D, seed=3)).requires_grad_()
    g = torch.from_numpy(_x(2, 24, D, seed=4))
    names = ("router.weight", "w1", "b1", "w2", "b2")

    route = layer.routing(x.detach())
    pairs = 48 * k
    dropped = pairs - int(route.keep.sum())
    assert dropped == 0 if case == "roomy" else dropped > 0, dropped
    if tied:
        logits = x.detach().reshape(48, D) @ layer.router.weight.T
        assert torch.equal(logits[:, 0], logits[:, 1])
        # the lower of two tied experts first, then its twin
        assert (route.expert[:, 0] % 2 == 0).all()
        if k == 2:
            assert torch.equal(route.expert[:, 1], route.expert[:, 0] + 1)
    if case == "slice":
        mine = ((route.expert >= e0) & (route.expert < e0 + held)).sum()
        assert 0 < int(mine) < pairs

    rows = []

    def recorded(*args):
        rows.append(t_moe._gather_rows_plain(*args[:2]))
        return real(*args)

    real = t_moe.gather_rows
    monkeypatch.setattr(t_moe, "gather_rows", recorded)
    with t_moe.collect_aux_losses() as sink:
        y = layer._forward_held(x, e0, held)
    params = dict(layer.named_parameters())
    got = torch.autograd.grad((y * g).sum() + sink[0],
                              [x] + [params[n] for n in names])

    xd = x.detach().clone().requires_grad_()
    dense = {n: params[n].detach().clone().requires_grad_() for n in names}
    xe, yd, aux = _dense_route(layer, dense, xd, e0, held)
    want = torch.autograd.grad((yd * g).sum() + aux,
                               [xd] + [dense[n] for n in names])

    assert torch.equal(rows[0].view(held, -1, D), xe)
    for name, a, b in [("y", y, yd), ("aux", sink[0], aux),
                       *zip(("x",) + names, got, want)]:
        limit = INDEX_ATOL * b.abs().max().item()
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=limit, rtol=0, err_msg=name)


def test_layer_builds_no_dense_routing(monkeypatch):
    """A forward and backward of ``MoEFFN`` in training mode never calls
    ``top_k_routing``, contracts no (S, E, C) tensor and accumulates
    nothing by index (no ``index_add``, ``scatter_add`` or accumulating
    ``index_put``: on a card these are atomics)."""
    def refused(*args, **kwargs):
        raise AssertionError("the layer built the dense routing")

    monkeypatch.setattr(t_moe, "top_k_routing", refused)
    seen, einsum = [], torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda eq, *ops: seen.append(eq) or einsum(eq, *ops))
    layer = t_moe.MoEFFN(16, 4, 32, top_k=2, capacity_factor=1.0,
                         device="cpu").train()
    x = torch.from_numpy(_x(2, 24, 16, seed=5)).requires_grad_()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t_moe.collect_aux_losses() as sink:
            y = layer(x)
        (y.square().sum() + sink[0]).backward()
    assert sorted(set(seen)) == ["ecd,edf->ecf", "ecf,efd->ecd"]
    ops = {e.key for e in prof.key_averages()}
    assert "aten::index_select" in ops
    assert not {o for o in ops if o.startswith(
        ("aten::index_add", "aten::scatter_add", "aten::index_put",
         "aten::_index_put"))}, ops
    assert x.grad is not None and layer.w1.grad is not None


def test_layer_runs_under_vmap_export_and_checkpoint():
    """The index route's gradient (an ``autograd.Function``) under
    ``torch.func.vmap`` over three members' stacked weights within 1e-6 of
    a loop over the members; a ``torch.export`` program of an eval forward
    and a ``torch.utils.checkpoint`` recomputation give the eager values."""
    from torch.func import functional_call, grad, stack_module_state, vmap

    torch.manual_seed(0)
    members = [t_moe.MoEFFN(16, 4, 32, top_k=2, capacity_factor=1.0,
                            device="cpu") for _ in range(3)]
    x = torch.from_numpy(_x(2, 12, 16, seed=6))

    def loss(params, x):
        return functional_call(members[0], params, (x,)).square().sum()

    params, _ = stack_module_state(members)
    batched = vmap(grad(loss), in_dims=(0, None))(params, x)
    for i in range(len(members)):
        one = grad(loss)({n: t[i] for n, t in params.items()}, x)
        for n in one:
            # vmap batches the members' matmuls: 1e-6 of the largest
            limit = 1e-6 * one[n].abs().max().item()
            torch.testing.assert_close(batched[n][i], one[n], atol=limit,
                                       rtol=0)

    layer = members[0].eval()
    with torch.no_grad():
        program = torch.export.export(layer, (x,)).run_decompositions({})
        torch.testing.assert_close(program.module()(x), layer(x), atol=0,
                                   rtol=0)
    layer.train()
    xs = [x.clone().requires_grad_() for _ in range(2)]
    torch.utils.checkpoint.checkpoint(layer, xs[0], use_reentrant=False
                                      ).square().sum().backward()
    layer(xs[1]).square().sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, atol=0, rtol=0)


def _grads_close(got: dict, want: dict):
    """Every gradient within GRAD_RTOL of the largest |want|."""
    g_max = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0,
                                   atol=GRAD_RTOL * g_max, err_msg=k)


def _sown(mut) -> jnp.ndarray:
    """Σ of the "losses" collection, as the JAX ``fit`` sums it."""
    leaves = jax.tree_util.tree_leaves(mut.get("losses", {}))
    return sum(jnp.sum(a) for a in leaves)


# (flax module, port module, input shape): B·T tokens of width D
MODULES = {
    "moe_ffn_top1": lambda: (
        j_moe.MoEFFN(16, 4, 32, top_k=1, capacity_factor=1.0),
        t_moe.MoEFFN(16, 4, 32, top_k=1, capacity_factor=1.0, device="cpu"),
        (2, 24, 16)),
    "moe_ffn_top2": lambda: (
        j_moe.MoEFFN(16, 4, 0, top_k=2), t_moe.MoEFFN(16, 4, 0, top_k=2,
                                                      device="cpu"),
        (2, 24, 16)),
    "transformer_block": lambda: (
        j_layers.TransformerBlock(32, 2, dropout=0.0, num_experts=4,
                                  moe_top_k=2),
        t_layers.TransformerBlock(32, 2, dropout=0.0, num_experts=4,
                                  moe_top_k=2), (2, 20, 32)),
}


def _module_call(fmod, variables, x, train):
    if isinstance(fmod, j_moe.MoEFFN):
        return fmod.apply(variables, x, train=train, mutable=["losses"])
    return fmod.apply(variables, x, train, mutable=["losses"])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_forward_and_gradients_match_jax(name):
    """The eval forward within 1e-5; in training mode mean(y·g) + the
    sown aux loss (of a size with the mean) within 1e-5 and the gradients
    of every weight and of x within 1e-4 of the largest."""
    fmod, tmod, shape = MODULES[name]()
    x = _x(*shape, seed=1)
    g = _x(*shape, seed=2)
    variables = seeded_variables(fmod, (x,))
    load_flax_variables(tmod, variables["params"])

    y_j, _ = jax.jit(lambda v, x: _module_call(fmod, v, x, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        y_t = tmod.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=FWD_ATOL,
                               rtol=0)

    def loss_j(params, x):
        y, mut = _module_call(fmod, {"params": params}, x, True)
        return jnp.mean(y * jnp.asarray(g)) + _sown(mut)

    loss_w, (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with t_moe.collect_aux_losses() as sink:
        y = tmod.train()(xt)
    assert len(sink) == 1
    loss_t = (y * torch.from_numpy(g)).mean() + t_moe.total_aux_loss(sink)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_w), atol=FWD_ATOL,
                               rtol=0)
    want = load_flax_variables(copy.deepcopy(tmod),
                               jax.tree.map(np.asarray, gp)).state_dict()
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    _grads_close({**got, "x": xt.grad.numpy()},
                 {**{k: v.numpy() for k, v in want.items()}, "x": gx})


def test_eval_forward_leaves_no_aux_loss():
    moe = t_moe.MoEFFN(16, 4, device="cpu")
    x = torch.from_numpy(_x(2, 8, 16))
    with t_moe.collect_aux_losses() as sink:
        moe.eval()(x)
        with torch.no_grad():
            moe.train()(x)
    assert len(sink) == 1       # the train-mode call only
    moe.train()(x)              # no collector open: nowhere to go
    assert t_moe.total_aux_loss([]) is None


V4_KW = dict(num_transformer_layers=1, num_heads=2, num_experts=4,
             moe_top_k=2)


def _v4_inputs(B=8, T=32):
    return dict(erp=_x(B, T, 18, seed=0), pw=_x(B, T, 75, seed=1),
                conn=_x(B, 459, seed=2))


def test_v4_with_moe_matches_jax():
    """TriModalFusionNetV4(num_experts=4, moe_top_k=2) at hidden 32: the
    eval forward (every field of ``ModelOutput``) within 1e-5; a train-mode
    step with dropout off on both sides (batch 8): the weighted CE plus the
    two blocks' aux losses within 1e-5, every gradient within 1e-4 of the
    largest, the BatchNorm statistics within 1e-5."""
    inputs = _v4_inputs()
    fmod = j_eeg.TriModalFusionNetV4(32, dropout=0.0, **V4_KW)
    tmod = t_eeg.TriModalFusionNetV4(32, dropout=0.0, device="cpu", **V4_KW)
    variables = seeded_variables(fmod, kwargs=inputs)
    load_flax_variables(tmod, variables["params"], variables["batch_stats"])
    ref = jax.jit(fmod.apply)(variables, **_to_jax(inputs))
    with torch.no_grad():
        out = tmod.eval()(**_to_torch(inputs))
    for a, b in zip(out, ref):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=FWD_ATOL, rtol=0)

    label = np.arange(8) % 2
    w = np.random.default_rng(4).uniform(0.5, 1.5, 8).astype(np.float32)
    cw = np.array([0.8, 1.3], np.float32)
    with flax_dropout_off():
        def loss_fn(params):
            o, mut = fmod.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                **_to_jax(inputs), train=True,
                mutable=["batch_stats", "losses"])
            task = j_losses.weighted_cross_entropy(
                o.logits, jnp.asarray(label), jnp.asarray(cw), jnp.asarray(w))
            return task + _sown(mut), (_sown(mut), mut["batch_stats"])

        (loss_j, (aux_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    _gate_dropout_off(tmod).train()
    with t_moe.collect_aux_losses() as sink:
        o = tmod(**_to_torch(inputs))
    assert len(sink) == 2       # one MoE block in each temporal encoder
    aux_t = t_moe.total_aux_loss(sink)
    loss_t = t_losses.weighted_cross_entropy(
        o.logits, torch.from_numpy(label), torch.from_numpy(cw),
        torch.from_numpy(w)) + aux_t
    loss_t.backward()
    np.testing.assert_allclose(aux_t.item(), float(aux_j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=FWD_ATOL,
                               rtol=0)
    want = load_flax_variables(copy.deepcopy(tmod),
                               jax.tree.map(np.asarray, grads_j),
                               jax.tree.map(np.asarray, stats_j)).state_dict()
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    _grads_close(got, {k: want[k].numpy() for k in got})
    for k, v in tmod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=FWD_ATOL, rtol=0, err_msg=k)


def test_init_weights_counts_the_expert_axis_in_fan_in():
    """flax's ``lecun_normal`` on (E, D, ff) takes fan_in = D·E: std
    1/√(64·4) = 0.0625 for (4, 64, 256), not 1/√64; ``w2`` ff·E. Biases
    zero, the router (D, E) over D."""
    moe = t_moe.MoEFFN(64, 4, device="cpu")
    init_weights(moe, torch.Generator().manual_seed(0))
    assert moe.w1.std().item() == pytest.approx(1 / np.sqrt(64 * 4), rel=0.02)
    assert moe.w2.std().item() == pytest.approx(1 / np.sqrt(256 * 4),
                                                rel=0.02)
    assert not moe.b1.any() and not moe.b2.any()
    want = jax.jit(j_moe.MoEFFN(64, 4).init)(jax.random.key(0),
                                             jnp.zeros((2, 512, 64)))
    for key in ("w1", "w2"):
        np.testing.assert_allclose(getattr(moe, key).std().item(),
                                   float(jnp.std(want["params"][key])),
                                   rtol=0.03)


def test_block_round_trips_the_flax_tree():
    """``flax_variables_from_module`` gives back a MoE block's flax tree,
    ``moe/router/kernel`` (D, E) and the (E, D, ff) / (E, ff, D) experts
    included, bit for bit."""
    fmod = j_layers.TransformerBlock(32, 2, num_experts=4)
    x = _x(2, 8, 32)
    variables = seeded_variables(fmod, (x,))
    tmod = load_flax_variables(
        t_layers.TransformerBlock(32, 2, num_experts=4), variables["params"])
    back = flax_variables_from_module(tmod)["params"]
    assert back["moe"]["router"]["kernel"].shape == (32, 4)
    assert back["moe"]["w1"].shape == (4, 32, 128)
    assert "ffn1" not in back
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, variables["params"]))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(variables["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
