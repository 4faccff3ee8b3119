"""The port's modules against the JAX package's, with the same weights.

Each case builds a flax module and its port, perturbs the flax variables
with seeded noise (so that biases and BatchNorm statistics are not at their
trivial initial values), moves them across with ``load_flax_variables`` and
compares the outputs in eval mode on the same numpy inputs. Widths are
narrow: hidden 32, fMRI 16, bridge 32, one layer, two heads. Tolerances:
1e-5 for single modules, 1e-4 for the composite nets (many more f32 sums in
another order). Where the JAX side routes to its flash kernel, it runs in
interpret mode, as the JAX package's own tests run it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.models import bridge as j_bridge
from multimodal_eeg_fmri_tpu.models import encoders as j_enc
from multimodal_eeg_fmri_tpu.models import fmri as j_fmri
from multimodal_eeg_fmri_tpu.models import fusion as j_fusion
from multimodal_eeg_fmri_tpu.models import layers as j_layers
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu_torch import init_weights, load_flax_variables
from multimodal_eeg_fmri_tpu_torch.models import bridge as t_bridge
from multimodal_eeg_fmri_tpu_torch.models import encoders as t_enc
from multimodal_eeg_fmri_tpu_torch.models import fmri as t_fmri
from multimodal_eeg_fmri_tpu_torch.models import fusion as t_fusion
from multimodal_eeg_fmri_tpu_torch.models import layers as t_layers
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4 as TTri
from multimodal_eeg_fmri_tpu_torch.models.multimodal import (
    MultimodalEndToEnd as TE2E,
)

jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

NARROW = dict(eeg_hidden_dim=32, fmri_hidden_dim=16, bridge_dim=32,
              num_transformer_layers=1, num_heads=2)
# the port's public models build on the GPU unless asked for the CPU
CPU = dict(device="cpu")


def _perturb(tree, r):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _perturb(v, r)
            continue
        x = np.asarray(v, np.float32)
        if k == "var":
            out[k] = r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif k == "mean":
            out[k] = (0.1 * r.standard_normal(x.shape)).astype(np.float32)
        else:
            out[k] = (x + 0.1 * r.standard_normal(x.shape)).astype(np.float32)
    return out


def _to_jax(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(a) for a in x)
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    return jnp.asarray(x)


def _to_torch(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(a) for a in x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x))


def _assert_close(port, ref, atol):
    if ref is None:
        assert port is None
    elif isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_close(a, b, atol)
    else:
        np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                                   atol=atol, rtol=0)


def _transfer(fmod, tmod, args, kwargs, seed=0):
    variables = jax.jit(fmod.init)(jax.random.key(seed), *_to_jax(args),
                                   **_to_jax(kwargs))
    variables = _perturb(variables, np.random.default_rng(seed + 1))
    load_flax_variables(tmod, variables.get("params", {}),
                        variables.get("batch_stats"))
    return variables


def run_pair(fmod, tmod, args=(), kwargs=None, seed=0):
    """(port output, JAX output) in eval mode with the same weights."""
    kwargs = kwargs or {}
    variables = _transfer(fmod, tmod, args, kwargs, seed)
    ref = jax.jit(fmod.apply)(variables, *_to_jax(args), **_to_jax(kwargs))
    with torch.no_grad():
        out = tmod.eval()(*_to_torch(args), **_to_torch(kwargs))
    return out, ref


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _e2e_inputs(B, T, seed=0):
    return dict(erp=_x(B, T, 18, seed=seed), pw=_x(B, T, 75, seed=seed + 1),
                conn=_x(B, 459, seed=seed + 2),
                activation=_x(B, 90, seed=seed + 3),
                connectivity=_x(B, 64, seed=seed + 4))


@pytest.fixture
def flash_calls(monkeypatch):
    """Route the JAX flash kernel through interpret mode and count the
    flash calls on both sides."""
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


def test_gelu_is_exact_erf_form():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        t_layers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(j_layers.gelu(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("length,d", [(48, 32), (10, 7), (1, 2)])
def test_sinusoidal_position_encoding(length, d):
    np.testing.assert_allclose(
        t_layers.sinusoidal_position_encoding(length, d).numpy(),
        np.asarray(j_layers.sinusoidal_position_encoding(length, d)),
        atol=1e-5, rtol=0)


def test_positional_encoding_module():
    x = _x(2, 40, 32)
    out, ref = run_pair(j_layers.PositionalEncoding(32),
                        t_layers.PositionalEncoding(32), (x,))
    _assert_close(out, ref, 1e-5)


def test_max_pool_time():
    x = _x(2, 9, 5)
    np.testing.assert_allclose(
        t_enc.max_pool_time(torch.from_numpy(x)).numpy(),
        np.asarray(j_enc.max_pool_time(jnp.asarray(x))), atol=0)


MASK = np.random.default_rng(9).random((3, 1, 5, 7)) > 0.3

# (flax module, port module, positional inputs, keyword inputs, atol)
MODULE_CASES = {
    "mlp_batch": lambda: (j_layers.MLP((24, 16)),
                          t_layers.MLP(20, (24, 16)), (_x(5, 20),), {}, 1e-5),
    "mlp_layer_no_final_act": lambda: (
        j_layers.MLP((24, 16), norm="layer", final_activation=False),
        t_layers.MLP(20, (24, 16), norm="layer", final_activation=False),
        (_x(5, 20),), {}, 1e-5),
    "classifier_head": lambda: (j_layers.ClassifierHead((24, 12), 3),
                                t_layers.ClassifierHead(20, (24, 12), 3),
                                (_x(5, 20),), {}, 1e-5),
    "mha_einsum": lambda: (j_layers.MultiHeadAttention(2),
                           t_layers.MultiHeadAttention(32, 2),
                           (_x(3, 5, 32), _x(3, 7, 32, seed=1),
                            _x(3, 7, 32, seed=2)), {}, 1e-5),
    "mha_einsum_mask": lambda: (j_layers.MultiHeadAttention(2),
                                t_layers.MultiHeadAttention(32, 2),
                                (_x(3, 5, 32), _x(3, 7, 32, seed=1),
                                 _x(3, 7, 32, seed=2)), {"mask": MASK}, 1e-5),
    "transformer_block": lambda: (j_layers.TransformerBlock(32, 2),
                                  t_layers.TransformerBlock(32, 2),
                                  (_x(2, 40, 32),), {}, 1e-5),
    "conv_bn_block": lambda: (j_enc.ConvBNBlock(16, 5),
                              t_enc.ConvBNBlock(6, 16, 5),
                              (_x(3, 40, 6),), {}, 1e-5),
    "multiscale_conv": lambda: (j_enc.MultiScaleConv(8),
                                t_enc.MultiScaleConv(10, 8),
                                (_x(2, 30, 10),), {}, 1e-5),
    "erp_encoder": lambda: (j_enc.ERPEncoder(32, 1, 2),
                            t_enc.ERPEncoder(18, 32, 1, 2),
                            (_x(2, 64, 18),), {}, 1e-5),
    "power_encoder": lambda: (j_enc.PowerEncoder(32, 1, 2),
                              t_enc.PowerEncoder(12, 32, 1, 2),
                              (_x(2, 64, 12),), {}, 1e-5),
    "conn_mlp_encoder": lambda: (j_enc.ConnMLPEncoder(32),
                                 t_enc.ConnMLPEncoder(15, 32),
                                 (_x(4, 3, 5),), {}, 1e-5),
    "learned_fusion": lambda: (j_fusion.LearnedFusion(3, 16),
                               t_fusion.LearnedFusion(3, 16),
                               ([_x(4, 16, seed=i) for i in range(3)],), {},
                               1e-5),
    "fmri_encoder": lambda: (j_fmri.FMRIEncoder(16),
                             t_fmri.FMRIEncoder(90, 16),
                             (_x(4, 90),), {}, 1e-5),
    "fmri_head_regression": lambda: (
        j_fmri._Head(16, 2, 0.0, "regression"),
        t_fmri._Head(16, 2, 0.0, "regression"), (_x(4, 16),), {}, 1e-5),
    "fmri_fusion_net": lambda: (j_fmri.FMRIFusionNet(16),
                                t_fmri.FMRIFusionNet(16, **CPU),
                                (), {"activation": _x(4, 90),
                                     "connectivity": _x(4, 64, seed=1)},
                                1e-4),
    "bridge_proj": lambda: (j_bridge._Proj(32, 0.1), t_bridge._Proj(20, 32, 0.1),
                            (_x(4, 20),), {}, 1e-5),
    "bridge_fusion_net": lambda: (
        j_bridge.BridgeFusionNet(32, 16, 32, num_heads=2),
        t_bridge.BridgeFusionNet(32, 16, 32, num_heads=2, **CPU),
        (), {"eeg": _x(4, 32), "fmri": _x(4, 16, seed=1)}, 1e-4),
    "trimodal_v4": lambda: (
        JTri(32, num_transformer_layers=1, num_heads=2),
        TTri(32, num_transformer_layers=1, num_heads=2, **CPU),
        (), {k: v for k, v in _e2e_inputs(3, 64).items()
             if k in ("erp", "pw", "conn")}, 1e-4),
}


@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_module_matches_jax(name):
    fmod, tmod, args, kwargs, atol = MODULE_CASES[name]()
    out, ref = run_pair(fmod, tmod, args, kwargs)
    _assert_close(out, ref, atol)


@pytest.mark.parametrize("impl,T", [("flash", 64), ("auto", 256)])
def test_mha_flash_route_matches_jax(flash_calls, impl, T):
    args = (_x(2, T, 32), _x(2, T, 32, seed=1), _x(2, T, 32, seed=2))
    out, ref = run_pair(j_layers.MultiHeadAttention(2, attn_impl=impl),
                        t_layers.MultiHeadAttention(32, 2, attn_impl=impl),
                        args)
    assert out[1] is None and ref[1] is None
    assert flash_calls["port"] == 1
    _assert_close(out, ref, 1e-5)


def test_transformer_block_flash_route_matches_jax(flash_calls):
    out, ref = run_pair(j_layers.TransformerBlock(32, 2),
                        t_layers.TransformerBlock(32, 2), (_x(2, 256, 32),))
    assert flash_calls["port"] == 1
    _assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("T,flash", [(64, 0), (512, 2)])
def test_multimodal_end_to_end_matches_jax(flash_calls, T, flash):
    """T=64 stays on the einsum route; at T=512 both temporal encoders'
    self-attention takes the flash route (one layer each here)."""
    inputs = _e2e_inputs(3, T)
    fmod, tmod = JE2E(**NARROW), TE2E(**NARROW, **CPU)
    # weights do not depend on T: initialise at a short epoch
    variables = _transfer(fmod, tmod, (), _e2e_inputs(3, 32))
    flash_calls.update(jax=0, port=0)
    ref = jax.jit(fmod.apply)(variables, **_to_jax(inputs))
    with torch.no_grad():
        out = tmod.eval()(**_to_torch(inputs))
    assert flash_calls == {"jax": flash, "port": flash}
    assert out.attn_weights.shape == (3, 1, 2)
    _assert_close(tuple(out), tuple(ref), 1e-4)


def test_conv_bn_train_mode_matches_jax():
    """Training-mode BatchNorm: batch statistics over (batch, time) and
    flax's momentum 0.99 on the running mean and on the running variance,
    which flax updates with the biased batch variance."""
    x = _x(3, 40, 6)
    fmod, tmod = j_enc.ConvBNBlock(16, 5), t_enc.ConvBNBlock(6, 16, 5)
    variables = _transfer(fmod, tmod, (x,), {})
    ref, upd = fmod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    out = tmod.train()(torch.from_numpy(x))
    _assert_close(out, ref, 1e-5)
    np.testing.assert_allclose(tmod.bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tmod.bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               atol=1e-6)


def test_drop_path():
    x = torch.ones(64, 3, 4)
    dp = t_layers.DropPath(0.5)
    assert torch.equal(dp.eval()(x), x)
    y = dp.train()(x)
    per_sample = y.reshape(64, -1)
    # each sample is dropped whole or kept and scaled by 1/keep
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert torch.all(per_sample.amin(1) == per_sample.amax(1))


@pytest.mark.parametrize("impl,kw,err", [
    ("flash", {"mask": True}, ValueError),
    ("flash", {"train": True}, ValueError),
    ("ring", {}, NotImplementedError),
    ("ring_local", {}, NotImplementedError),
])
def test_mha_fences(impl, kw, err):
    mha = t_layers.MultiHeadAttention(32, 2, dropout=0.1, attn_impl=impl)
    mha.train(kw.get("train", False))
    x = torch.zeros(1, 4, 32)
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool) if "mask" in kw else None
    with pytest.raises(err):
        mha(x, x, x, mask=mask)


def test_moe_not_ported_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_layers.TransformerBlock(32, 2, num_experts=4)


def test_load_flax_variables_is_strict():
    fmod, tmod = j_layers.MLP((8,)), t_layers.MLP(4, (8,))
    v = fmod.init(jax.random.key(0), jnp.zeros((2, 4)))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    load_flax_variables(tmod, params, stats)
    with pytest.raises(ValueError, match="not used"):
        load_flax_variables(tmod, {**params, "extra": np.zeros(1)}, stats)
    with pytest.raises(ValueError, match="no leaf"):
        load_flax_variables(tmod, params, None)
    bad = {**params, "dense_0": {**params["dense_0"], "bias": np.zeros(9)}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tmod, bad, stats)


def test_init_weights_follows_flax_initialisers():
    model = TE2E(**NARROW, **CPU)
    a = init_weights(model, torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in a.state_dict().items()}
    init_weights(model, torch.Generator().manual_seed(3))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    w = model.eeg.conn_encoder.mlp.dense_0.weight       # fan-in 459
    assert abs(w.std().item() * np.sqrt(459) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(459)
    conv = model.eeg.erp_encoder.conv1.conv.weight      # fan-in 18 * 7
    assert abs(conv.std().item() * np.sqrt(18 * 7) - 1.0) < 0.1
    assert torch.all(model.eeg.fusion.fusion_logits == 1.0)
    assert model.eeg.fusion.temperature.item() == 1.0
    assert model.fmri.activation_weight.item() == 0.5
    assert torch.all(model.bridge.cls_ln.weight == 1.0)
    assert torch.all(model.eeg.conn_encoder.mlp.dense_0.bias == 0.0)


def test_freeze_encoders_detaches_embeddings():
    model = init_weights(TE2E(**NARROW, freeze_encoders=True, **CPU),
                         torch.Generator().manual_seed(0)).eval()
    out = model(**_to_torch(_e2e_inputs(2, 32)))
    out.logits.sum().backward()
    assert model.eeg.fusion.gate1.weight.grad is None
    assert model.fmri.fusion.dense_0.weight.grad is None
    assert model.bridge.cls_out.weight.grad is not None
