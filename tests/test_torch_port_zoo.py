"""The port's model zoo against the JAX package's, with the same weights.

Every new module and model of ``multimodal_eeg_fmri_tpu_torch.models``:
``SmartFusionNetV4`` with ``BiDirectionalCrossAttention``, the V3 baselines
``ERPOnlyNet`` / ``PWOnlyNet`` on ``ERPEncoderV3`` / ``PowerEncoderV3``,
the fMRI baselines (both tasks), V4-Lite (``LiteERPEncoder``,
``LitePowerEncoder``, ``AttnConnEncoder``, ``HybridFusion``) and the graph
net (``GraphConnEncoder``), and ``MODEL_REGISTRY``.

Widths are narrow: hidden 16-32, one layer, two heads, T=32, and N=8
nodes with M=2 metrics for the graph encoder. The flax variables are
seeded random values in the layout of the flax module's ``init`` (read
with ``jax.eval_shape``, which compiles nothing), moved across with
``load_flax_variables``. Tolerances, as in
``test_torch_port_models.py``: 1e-5 for single modules, 1e-4 for composite
nets; in train mode with dropout off on both sides (flax ``Dropout``
patched to the identity, the port built with dropout 0 and
``LearnedFusion``'s fixed gate dropout off) the loss, the input and weight
gradients and the updated BatchNorm statistics within 1e-4. At T=512 the
V4 encoders' attention takes the flash route on both sides (JAX in
interpret mode). ``test_torch_port_zoo_suite.py`` holds the reference's
four-model suite through ``run_model_suite``, with JAX runs of its own.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_cv import flax_dropout_off
from test_torch_port_models import _assert_close, _to_jax, _to_torch, _x

from multimodal_eeg_fmri_tpu import models as j_models
from multimodal_eeg_fmri_tpu.models import eeg as j_eeg
from multimodal_eeg_fmri_tpu.models import encoders as j_enc
from multimodal_eeg_fmri_tpu.models import fmri as j_fmri
from multimodal_eeg_fmri_tpu.models import fusion as j_fusion
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu_torch import init_weights, load_flax_variables
from multimodal_eeg_fmri_tpu_torch import models as t_models
from multimodal_eeg_fmri_tpu_torch.convert import flax_variables_from_module
from multimodal_eeg_fmri_tpu_torch.models import eeg as t_eeg
from multimodal_eeg_fmri_tpu_torch.models import encoders as t_enc
from multimodal_eeg_fmri_tpu_torch.models import fmri as t_fmri
from multimodal_eeg_fmri_tpu_torch.models import fusion as t_fusion
from multimodal_eeg_fmri_tpu_torch.models import layers as t_layers
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.ops import losses as t_losses
from multimodal_eeg_fmri_tpu_torch.ops import moe as t_moe

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

CPU = dict(device="cpu")
V4 = dict(num_transformer_layers=1, num_heads=2)
N_NODES, N_METRICS = 8, 2
ATOL = 1e-4
CLASS_WEIGHTS = np.array([0.8, 1.3], np.float32)


def _eeg(B=3, T=32, seed=0, gnn=False):
    conn = (np.random.default_rng(seed + 2).uniform(
        0, 1, (B, N_NODES, N_NODES, N_METRICS)).astype(np.float32) if gnn
        else _x(B, 459, seed=seed + 2))
    return dict(erp=_x(B, T, 18, seed=seed), pw=_x(B, T, 75, seed=seed + 1),
                conn=conn)


def _fmri(B=4, seed=0):
    return dict(activation=_x(B, 90, seed=seed),
                connectivity=_x(B, 64, seed=seed + 1))


# (flax module, port module, positional inputs, keyword inputs, atol)
MODULE_CASES = {
    "erp_encoder_v3": lambda: (j_enc.ERPEncoderV3(16),
                               t_enc.ERPEncoderV3(18, 16),
                               (_x(3, 32, 18),), {}, 1e-5),
    "power_encoder_v3": lambda: (j_enc.PowerEncoderV3(16),
                                 t_enc.PowerEncoderV3(12, 16),
                                 (_x(3, 32, 12),), {}, 1e-5),
    "lite_erp_encoder": lambda: (j_enc.LiteERPEncoder(24),
                                 t_enc.LiteERPEncoder(18, 24),
                                 (_x(3, 33, 18),), {}, 1e-5),
    "lite_power_encoder": lambda: (j_enc.LitePowerEncoder(24),
                                   t_enc.LitePowerEncoder(12, 24),
                                   (_x(3, 32, 12),), {}, 1e-5),
    "attn_conn_encoder": lambda: (j_enc.AttnConnEncoder(16),
                                  t_enc.AttnConnEncoder(15, 16),
                                  (_x(4, 3, 5),), {}, 1e-5),
    "graph_conn_encoder": lambda: (
        j_enc.GraphConnEncoder(16, 2, 0.5),
        t_enc.GraphConnEncoder(N_NODES, N_METRICS, 16, 2, 0.5),
        (_eeg(gnn=True)["conn"],), {}, 1e-5),
    "graph_conn_encoder_one_metric": lambda: (
        j_enc.GraphConnEncoder(16, 2, 0.6),
        t_enc.GraphConnEncoder(N_NODES, 1, 16, 2, 0.6),
        (_eeg(gnn=True)["conn"][..., 0],), {}, 1e-5),
    "bidirectional_cross_attention": lambda: (
        j_fusion.BiDirectionalCrossAttention(32, 2),
        t_fusion.BiDirectionalCrossAttention(32, 2),
        (_x(4, 32), _x(4, 32, seed=1)), {}, 1e-5),
    "hybrid_fusion": lambda: (
        j_fusion.HybridFusion(16, conn_boost=1.3),
        t_fusion.HybridFusion(16, conn_boost=1.3),
        (_x(4, 16), _x(4, 16, seed=1), _x(4, 16, seed=2)), {}, 1e-5),
}

# (flax model, port model, keyword inputs); at the nets' tolerance
NET_CASES = {
    "smart_fusion_v4": lambda d, B=3: (
        j_eeg.SmartFusionNetV4(32, dropout=d, **V4),
        t_eeg.SmartFusionNetV4(32, dropout=d, **V4, **CPU), _eeg(B)),
    "smart_fusion_v4_no_cross_attention": lambda d, B=3: (
        j_eeg.SmartFusionNetV4(32, dropout=d, use_cross_attention=False,
                               **V4),
        t_eeg.SmartFusionNetV4(32, dropout=d, use_cross_attention=False,
                               **V4, **CPU), _eeg(B)),
    "erp_only": lambda d, B=3: (j_eeg.ERPOnlyNet(16, dropout=d),
                           t_eeg.ERPOnlyNet(16, dropout=d, **CPU), _eeg(B)),
    "pw_only": lambda d, B=3: (j_eeg.PWOnlyNet(16, dropout=d),
                          t_eeg.PWOnlyNet(16, dropout=d, **CPU), _eeg(B)),
    "trimodal_lite": lambda d, B=3: (
        j_eeg.TriModalFusionNetV4Lite(32, dropout=d),
        t_eeg.TriModalFusionNetV4Lite(32, dropout=d, **CPU), _eeg(B)),
    "trimodal_gnn": lambda d, B=3: (
        j_eeg.TriModalFusionNetGNN(32, dropout=d, **V4),
        t_eeg.TriModalFusionNetGNN(32, dropout=d, n_nodes=N_NODES,
                                   n_metrics=N_METRICS, **V4, **CPU),
        _eeg(B, gnn=True)),
    "fmri_activation_only": lambda d, B=3: (
        j_fmri.FMRIActivationOnly(16, dropout=d),
        t_fmri.FMRIActivationOnly(16, dropout=d, **CPU), _fmri(B)),
    "fmri_activation_only_regression": lambda d, B=3: (
        j_fmri.FMRIActivationOnly(16, dropout=d, task="regression"),
        t_fmri.FMRIActivationOnly(16, dropout=d, task="regression", **CPU),
        _fmri(B)),
    "fmri_connectivity_only": lambda d, B=3: (
        j_fmri.FMRIConnectivityOnly(16, dropout=d),
        t_fmri.FMRIConnectivityOnly(16, dropout=d, **CPU), _fmri(B)),
    "fmri_connectivity_only_regression": lambda d, B=3: (
        j_fmri.FMRIConnectivityOnly(16, dropout=d, task="regression"),
        t_fmri.FMRIConnectivityOnly(16, dropout=d, task="regression",
                                    **CPU), _fmri(B)),
}


def _variables(fmod, args=(), kwargs=None, seed=0):
    """Seeded flax variables of ``fmod`` for these inputs: kernels scaled
    by their fan-in, biases and running means near 0, running variances in
    [0.5, 1.5], every other leaf (norm scales, fusion logits, temperatures,
    gates) near 1."""
    shapes = jax.eval_shape(fmod.init, jax.random.key(0), *_to_jax(args),
                            **_to_jax(kwargs or {}))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name, n = path[-1].key, r.standard_normal(s.shape)
        if name == "kernel":
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * n
        elif name == "var":
            v = r.uniform(0.5, 1.5, s.shape)
        else:
            v = 1.0 + 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def run_pair(fmod, tmod, args=(), kwargs=None, seed=0):
    """(port output, JAX output) in eval mode with the same weights."""
    kwargs = kwargs or {}
    variables = _variables(fmod, args, kwargs, seed)
    load_flax_variables(tmod, variables["params"],
                        variables.get("batch_stats"))
    ref = jax.jit(fmod.apply)(variables, *_to_jax(args), **_to_jax(kwargs))
    with torch.no_grad():
        out = tmod.eval()(*_to_torch(args), **_to_torch(kwargs))
    return out, ref


@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_module_matches_jax(name):
    fmod, tmod, args, kwargs, atol = MODULE_CASES[name]()
    out, ref = run_pair(fmod, tmod, args, kwargs)
    _assert_close(out, ref, atol)


@pytest.mark.parametrize("name", sorted(NET_CASES))
def test_net_matches_jax(name):
    """Eval forward at each model's default dropout: every field of
    ``ModelOutput``."""
    fmod, tmod, inputs = NET_CASES[name](0.3)
    out, ref = run_pair(fmod, tmod, (), inputs)
    _assert_close(tuple(out), tuple(ref), ATOL)


def _gate_dropout_off(model):
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    return model


def _loss_j(out, batch, regression):
    if regression:
        return j_losses.mse_loss(out.logits, jnp.asarray(batch["target"]),
                                 jnp.asarray(batch["weight"]))
    return j_losses.weighted_cross_entropy(
        out.logits, jnp.asarray(batch["label"]), jnp.asarray(CLASS_WEIGHTS),
        jnp.asarray(batch["weight"]))


def _loss_t(out, batch, regression):
    if regression:
        return t_losses.mse_loss(out.logits, torch.from_numpy(batch["target"]),
                                 torch.from_numpy(batch["weight"]))
    return t_losses.weighted_cross_entropy(
        out.logits, torch.from_numpy(batch["label"]),
        torch.from_numpy(CLASS_WEIGHTS), torch.from_numpy(batch["weight"]))


def _by_name(model, flax_params, flax_stats):
    """Flax trees as the port's state dict: gradients and statistics by
    parameter name."""
    return load_flax_variables(
        copy.deepcopy(model), jax.tree.map(np.asarray, flax_params),
        jax.tree.map(np.asarray, flax_stats)).state_dict()


TRAIN_CASES = ["smart_fusion_v4", "erp_only", "pw_only", "trimodal_lite",
               "trimodal_gnn", "fmri_activation_only_regression",
               "fmri_connectivity_only"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_net_train_mode_gradients_match_jax(name):
    """One train-mode forward and backward with dropout off on both sides:
    the loss (weighted CE, or weighted MSE for regression), every weight
    gradient, the input gradients and the updated BatchNorm statistics."""
    # batch 8: BatchNorm's training-mode statistics over 3 rows are
    # ill-conditioned enough to part f32 sums taken in another order
    fmod, tmod, inputs = NET_CASES[name](0.0, B=8)
    regression = name.endswith("regression")
    B = next(iter(inputs.values())).shape[0]
    r = np.random.default_rng(4)
    batch = dict(label=np.arange(B, dtype=np.int32) % 2,
                 target=r.standard_normal(B).astype(np.float32),
                 weight=r.uniform(0.5, 1.5, B).astype(np.float32))
    with flax_dropout_off():
        variables = _variables(fmod, kwargs=inputs)

        def loss_fn(params, x):
            out, mut = fmod.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                **x, train=True, mutable=["batch_stats"])
            return _loss_j(out, batch, regression), mut["batch_stats"]

        (loss_j, stats_j), (grads_j, dx_j) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
            variables["params"], _to_jax(inputs))
    load_flax_variables(tmod, variables["params"],
                        variables["batch_stats"])
    _gate_dropout_off(tmod).train()
    x_t = {k: v.requires_grad_() for k, v in _to_torch(inputs).items()}
    loss_t = _loss_t(tmod(**x_t), batch, regression)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=ATOL)
    for k, v in x_t.items():
        # an input the model ignores gets no gradient, and zeros in JAX
        got = np.zeros(v.shape, np.float32) if v.grad is None else v.grad
        np.testing.assert_allclose(got, np.asarray(dx_j[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    want = _by_name(tmod, grads_j, stats_j)
    # HybridFusion's final_gate feeds only the weight summary, not the
    # logits: no gradient here, zeros in JAX
    grads_t = {k: torch.zeros_like(p) if p.grad is None else p.grad
               for k, p in tmod.named_parameters()}
    stats_t = {k: v for k, v in tmod.state_dict().items() if k not in grads_t}
    for k, got in {**grads_t, **stats_t}.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got.detach().numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)


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


@pytest.mark.parametrize("name", ["smart_fusion_v4", "trimodal_gnn"])
def test_flash_route_nets_match_jax(flash_calls, name):
    """At T=512 the ERP (T/2 = 256) and PW (512) attention of the two
    models on the V4 encoders take the flash route on both sides (one
    layer each here); the conv-only nets and the 2-token attentions take
    none."""
    fmod, tmod, _ = NET_CASES[name](0.3)
    inputs = _eeg(B=2, T=512, gnn=name == "trimodal_gnn")
    variables = _variables(fmod, kwargs=inputs)
    load_flax_variables(tmod, variables["params"], variables["batch_stats"])
    flash_calls.update(jax=0, port=0)
    ref = jax.jit(fmod.apply)(variables, **_to_jax(inputs))
    with torch.no_grad():
        out = tmod.eval()(**_to_torch(inputs))
    assert flash_calls == {"jax": 2, "port": 2}
    _assert_close(tuple(out), tuple(ref), ATOL)


@pytest.mark.parametrize("name", ["erp_only", "pw_only", "trimodal_lite",
                                  "fmri_activation_only"])
def test_conv_and_mlp_nets_launch_no_kernel(monkeypatch, name):
    """The nets without a temporal transformer, at T=512, in eval and in
    a train-mode backward: the flash forward is never called."""
    _, tmod, inputs = NET_CASES[name](0.0)
    if "erp" in inputs:
        inputs = _eeg(B=2, T=512)
    init_weights(tmod, torch.Generator().manual_seed(0))
    calls = []
    real = port_attn._flash_forward
    monkeypatch.setattr(port_attn, "_flash_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        tmod.eval()(**_to_torch(inputs))
    tmod.train()(**_to_torch(inputs)).logits.sum().backward()
    assert not calls


def _flax_shapes(tree):
    return {k: (_flax_shapes(v) if isinstance(v, dict) or hasattr(v, "items")
                else tuple(np.shape(v))) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(NET_CASES))
def test_flax_variables_round_trip_bit_for_bit(name):
    """``flax_variables_from_module`` gives back the flax variables that
    ``load_flax_variables`` put in, leaf for leaf and bit for bit (the
    graph encoder's bias-less layers included)."""
    fmod, tmod, inputs = NET_CASES[name](0.3)
    variables = jax.eval_shape(fmod.init, jax.random.key(0),
                               **_to_jax(inputs))
    r = np.random.default_rng(2)
    variables = jax.tree.map(
        lambda s: r.standard_normal(s.shape).astype(np.float32) + 1.5,
        variables)
    load_flax_variables(tmod, variables["params"], variables["batch_stats"])
    back = flax_variables_from_module(tmod)
    assert _flax_shapes(back) == _flax_shapes(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables),
                    strict=True):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


REGISTRY_INPUTS = {
    "trimodal": lambda: _eeg(B=2, T=16),
    "trimodal_lite": lambda: _eeg(B=2, T=16),
    "trimodal_gnn": lambda: dict(
        _eeg(B=2, T=16), conn=np.random.default_rng(0).uniform(
            0, 1, (2, 18, 18, 3)).astype(np.float32)),
    "fusion": lambda: _eeg(B=2, T=16),
    "erponly": lambda: _eeg(B=2, T=16),
    "pwonly": lambda: _eeg(B=2, T=16),
    "fmri_fusion": lambda: _fmri(B=2),
    "fmri_activation_only": lambda: _fmri(B=2),
    "fmri_connectivity_only": lambda: _fmri(B=2),
    "bridge": lambda: dict(eeg=_x(2, 128), fmri=_x(2, 64, seed=1)),
    "multimodal_e2e": lambda: {**_eeg(B=2, T=16), **_fmri(B=2)},
    "long_context": lambda: dict(erp=_x(2, 16, 18)),
}


def test_registry_keys_are_jax_less_long_context():
    """The two registries are equal, ``long_context`` included: the same
    keys, and classes of the same names."""
    assert set(t_models.MODEL_REGISTRY) == set(j_models.MODEL_REGISTRY)
    assert "long_context" in t_models.MODEL_REGISTRY
    for name, cls in t_models.MODEL_REGISTRY.items():
        assert cls.__name__ == j_models.MODEL_REGISTRY[name].__name__, name
        assert getattr(t_models, cls.__name__) is cls
        assert cls.__name__ in t_models.__all__


@pytest.mark.parametrize("name", sorted(REGISTRY_INPUTS))
def test_registry_model_initialises_in_flax_layout(name):
    """Each registry model at its default widths: ``init_weights`` fills
    every parameter (none is left at the NaN put there first), with flax's
    special initial values, and the weights have the layout of the JAX
    model's ``init`` on the reference's input widths."""
    model = t_models.MODEL_REGISTRY[name](device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    init_weights(model, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    inputs = REGISTRY_INPUTS[name]()
    want = jax.eval_shape(j_models.MODEL_REGISTRY[name]().init,
                          jax.random.key(0), **_to_jax(inputs))
    assert _flax_shapes(flax_variables_from_module(model)) == _flax_shapes(
        {"params": want["params"],
         "batch_stats": want.get("batch_stats", {})})
    for m in model.modules():
        if isinstance(m, t_fusion.HybridFusion):
            assert m.final_gate.tolist() == pytest.approx([0.6, 0.4])
        if isinstance(m, t_layers.Dense) and m.bias is not None:
            assert torch.all(m.bias == 0)
    with torch.no_grad():
        out = model.eval()(**_to_torch(inputs))
    assert torch.isfinite(out.logits).all()


@pytest.mark.parametrize("name", sorted(REGISTRY_INPUTS))
def test_registry_model_builds_on_the_gpu_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default builds there")
    cls = t_models.MODEL_REGISTRY[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()
    assert next(cls(device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("what,match", [
    ("lc_ring_moe", "queue A item 7b"), ("lc_expert_axis", "queue A item 7b"),
    ("moe_mesh", "queue A item 7b"), ("moe_expert_axis", "queue A item 7b")])
def test_unported_guards_name_their_queue_item(what, match):
    """The paths these guards held back (queue A item 7b, ported) build and
    run, on layout-only meshes of one rank: MoE blocks on the ring, the
    classifier's and the MoE layer's expert axis, and the MoE layer with a
    mesh; with no axis sharded each equals the same layer without one."""
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
    from multimodal_eeg_fmri_tpu_torch.parallel import Mesh

    assert "7b" in match
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 32)).astype(np.float32))
    one = Mesh(np.zeros((1, 1), np.int64), ("seq", "expert"))
    if what.startswith("moe"):
        kw = (dict(mesh=one) if what == "moe_mesh"
              else dict(mesh=one, expert_axis="expert"))
        torch.manual_seed(0)
        layer = t_moe.MoEFFN(32, 4, **kw, device="cpu")
        torch.manual_seed(0)
        plain = t_moe.MoEFFN(32, 4, device="cpu")
        with torch.no_grad():
            torch.testing.assert_close(layer(x), plain(x), atol=0, rtol=0)
        return
    kw = (dict(attn_impl="ring", num_experts=4) if what == "lc_ring_moe"
          else dict(expert_axis="expert", num_experts=4))
    model = LongContextClassifier(mesh=one, hidden_dim=32, num_layers=1,
                                  in_channels=32, **kw, device="cpu")
    with torch.no_grad():
        out = model.eval()(erp=x)
    assert out.logits.shape == (2, 2) and torch.isfinite(out.logits).all()
