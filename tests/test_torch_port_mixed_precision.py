"""The port's bf16 forward against the JAX package's, module by module.

Under ``compute_dtype="bfloat16"`` the JAX package's ``fit`` casts the
params and the inputs to bf16 and runs the train-mode forward in that
dtype. Its program rounds the output of every op to bf16: flax's ``Dense``
and ``Conv`` round the product and then the bias sum, ``jax.nn.gelu`` and
``jax.nn.softmax`` round each op of their formulas, the norms compute in f32
and round once. The reference here is that program compiled with
``xla_allow_excess_precision=False``; by default XLA on the CPU keeps a
fused chain of bf16 ops in f32 and rounds once where it stores, which no
other backend is bound to.

One compiled train-mode apply of the narrow ``MultimodalEndToEnd`` records
every module's inputs and output (flax's ``intercept_methods``); each port
module then gets the same bf16 inputs and bf16 params. A module that rounds
where flax does differs only where its f32 sums, taken in another order,
round to another bf16 value: at most 0.2% of its elements (measured: 0.13%
at most, in a BatchNorm). A rounding put elsewhere changes a fifth or more
of them (measured before the port's layers followed flax: ``addmm`` Dense
21-34%, ``F.gelu`` in a ConvBNBlock 50%, attention 53-65%). The deep
encoders are not held to this: one early difference moves the batch
statistics of every later BatchNorm. The model's logits are held end to
end instead, by their relative L2 distance: 4.6e-3 from the JAX package's
bf16 logits (limit 6e-3), where the f32 logits lie 1.17e-2 away.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_fit_extras import (
    N_TRAIN,
    T,
    data,
    exact_parity,
    seeded_variables,
)
from test_torch_port_train import NARROW, _port_model
from torch.func import functional_call

from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu_torch.models import (
    bridge,
    encoders,
    fmri,
    fusion,
    layers,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import split_batch

HELD = (layers.Dense, torch.nn.LayerNorm, layers.BatchNorm,
        layers.MultiHeadAttention, layers.TransformerBlock, layers.MLP,
        layers.ClassifierHead, layers.PositionalEncoding,
        encoders.ConvBNBlock, encoders.MultiScaleConv,
        encoders.ConnMLPEncoder, fusion.LearnedFusion, fmri.FMRIEncoder,
        fmri._Head, bridge._Proj)
MAX_MISMATCH = 2e-3
LOGITS_RTOL = 6e-3


def _bf16(tree):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _first(out):
    out = getattr(out, "logits", out)
    return out[0] if isinstance(out, tuple) else out


def _torch(x):
    """A JAX array as a torch tensor of the same dtype; lists mapped."""
    if isinstance(x, (list, tuple)):
        return type(x)(_torch(a) for a in x)
    if x.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def recorded():
    """(inputs, each module's recorded (args, output) by path, the logits)
    of one bf16 train-mode apply, compiled without excess precision."""
    variables = seeded_variables(N_TRAIN, T)
    train, _ = data()
    inputs = {k: jnp.asarray(v) for k, v in split_batch(train).items()}

    def apply(params, inputs):
        rec = {}

        def intercept(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            if ctx.method_name == "__call__":
                rec.setdefault(".".join(ctx.module.scope.path),
                               (args, _first(out)))
            return out

        with fnn.intercept_methods(intercept):
            out, _ = JE2E(**NARROW).apply(
                {"params": _bf16(params),
                 "batch_stats": variables["batch_stats"]},
                **_bf16(inputs), train=True, mutable=["batch_stats", "losses"])
        return out.logits, {k: v for k, v in rec.items()
                            if all(hasattr(a, "dtype") for a in
                                   jax.tree.leaves(v))}

    with exact_parity(variables):
        logits, rec = jax.jit(apply).lower(
            variables["params"], inputs).compile(
            compiler_options={"xla_allow_excess_precision": False})(
            variables["params"], inputs)
    return variables, inputs, rec, logits


def _mismatch(got, want):
    """Where ``got`` differs from flax's ``want`` (a DenseGeneral's
    (heads, head_dim) output axes flattened)."""
    want = np.asarray(want.astype(jnp.float32)).reshape(got.shape)
    return got.float().numpy() != want


def _share(masks):
    """The share of differing elements over a list of masks."""
    return np.concatenate([m.ravel() for m in masks]).mean()


def test_bf16_modules_round_as_flax(recorded):
    """Each held module, given flax's bf16 inputs and the bf16 params,
    returns flax's bf16 output but for at most 0.2% of the elements; the
    Dense layers as one ``addmm`` (bias inside the product's rounding)
    would differ in a fifth of theirs."""
    variables, _, rec, _ = recorded
    model = _port_model(variables).train()
    params = {k: p.detach().bfloat16() for k, p in model.named_parameters()}
    held, dense, fused = {}, [], []
    for path, module in model.named_modules():
        if not isinstance(module, HELD) or path not in rec:
            continue
        args, want = rec[path]
        if (isinstance(module, layers.BatchNorm) and args[0].ndim != 2):
            continue  # (B, T, C) in flax, (B, C, T) in the ConvBNBlock
        sub = {k[len(path) + 1:]: p for k, p in params.items()
               if k.startswith(path + ".")}
        targs = tuple(_torch(a) for a in args)
        if (isinstance(module, layers.Dense)
                and targs[0].shape[-1] != module.in_features):
            targs = (targs[0].flatten(-2),)  # the (heads, head_dim) axes
        with torch.no_grad():
            got = _first(functional_call(module, sub, targs))
        assert got.dtype == torch.bfloat16, path
        held[path] = _mismatch(got, want)
        if isinstance(module, layers.Dense):
            dense.append(held[path])
            with torch.no_grad():
                fused.append(_mismatch(F.linear(
                    targs[0], sub["weight"], sub["bias"]), want))
    assert len(held) >= 60, sorted(held)
    kinds = {type(m).__name__ for p, m in model.named_modules() if p in held}
    assert kinds == {c.__name__ for c in HELD}, kinds
    worst = max(held, key=lambda p: held[p].mean())
    assert held[worst].mean() <= MAX_MISMATCH, (worst, held[worst].mean())
    assert _share(dense) <= MAX_MISMATCH and _share(fused) >= 0.1, (
        _share(dense), _share(fused))


def test_bf16_logits_match_jax(recorded):
    """The whole bf16 train-mode forward: the port's logits within 6e-3
    (relative L2) of the JAX package's bf16 logits, where the f32 forward's
    logits lie farther than 1e-2."""
    variables, inputs, _, want = recorded
    want = np.asarray(want.astype(jnp.float32))
    logits = {}
    for dt in (torch.bfloat16, torch.float32):
        model = _port_model(variables).train()
        params = {k: p.detach().to(dt) for k, p in model.named_parameters()}
        x = {k: _torch(v).to(dt) if v.dtype == jnp.float32 else _torch(v)
             for k, v in inputs.items()}
        with torch.no_grad():
            logits[dt] = functional_call(model, params, (), x).logits
    assert logits[torch.bfloat16].dtype == torch.bfloat16

    def rel(got):
        return (np.linalg.norm(got.float().numpy() - want)
                / np.linalg.norm(want))

    assert rel(logits[torch.bfloat16]) <= LOGITS_RTOL, rel(
        logits[torch.bfloat16])
    assert rel(logits[torch.float32]) >= 1e-2, rel(logits[torch.float32])
