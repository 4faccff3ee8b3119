"""The port's Mixture-of-Experts FFN against the JAX package's.

``top_k_routing`` on the same f32 logits (k ∈ {1, 2}, capacity below and
above the token count, tied logits); ``MoEFFN`` on its identical-expert
oracles; ``MoEFFN``, ``TransformerBlock(num_experts=4)`` and
``TriModalFusionNetV4(num_experts=4, moe_top_k=2)`` with the same seeded
flax variables (``load_flax_variables``): the eval forward within 1e-5, and
in training mode the loss with the sown aux losses and every gradient
within 1e-4 of the largest; ``init_weights``' expert fan-in. Widths are
narrow: D = 16-32, 4 experts, ff 32-64, T ≤ 32, one layer.
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
