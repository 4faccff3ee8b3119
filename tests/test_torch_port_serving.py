"""The port's ``Predictor`` against the JAX package's, with the same weights.

Narrow ``MultimodalEndToEnd`` (hidden 32, fMRI 16, bridge 32, one layer, two
heads) at a short epoch. Tolerance: probabilities within 1e-5 (f32 softmax of
logits that agree to ~1e-6 at this width).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu.serving import Predictor as JPredictor
from multimodal_eeg_fmri_tpu_torch import (
    MultimodalEndToEnd,
    Predictor,
    init_weights,
    load_flax_variables,
)
from multimodal_eeg_fmri_tpu_torch.serving import RESERVED_KEYS, _pad_chunk

NARROW = dict(eeg_hidden_dim=32, fmri_hidden_dim=16, bridge_dim=32,
              num_transformer_layers=1, num_heads=2)


def _inputs(n, T=48, seed=0):
    r = np.random.default_rng(seed)

    def x(*shape):
        return r.standard_normal(shape).astype(np.float32)

    return dict(erp=x(n, T, 18), pw=x(n, T, 75), conn=x(n, 459),
                activation=x(n, 90), connectivity=x(n, 64))


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables as numpy, port model with those weights)."""
    jmodel = JE2E(**NARROW)
    variables = jax.jit(jmodel.init)(jax.random.key(0), **_inputs(4, 16))
    r = np.random.default_rng(1)
    # move the BatchNorm statistics off their initial values
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (r.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                         if path[-1].key == "var" else
                         np.asarray(v) + 0.05 * r.standard_normal(
                             np.shape(v)).astype(np.float32)),
        variables)
    port = load_flax_variables(MultimodalEndToEnd(**NARROW, device="cpu"),
                               variables["params"], variables["batch_stats"])
    return jmodel, variables, port


def test_probabilities_match_jax(models):
    jmodel, variables, port = models
    inputs = _inputs(11, seed=2)
    ref = JPredictor(jmodel, variables["params"], variables["batch_stats"],
                     batch_size=4, temperature=1.7)(**inputs)
    out = Predictor(port, batch_size=4, temperature=1.7)(**inputs)
    assert out.shape == (11, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)


def test_logits_match_jax_and_reserved_keys_are_dropped(models):
    jmodel, variables, port = models
    inputs = _inputs(5, seed=3)
    extra = {"label": np.zeros(5, np.int32), "subject": np.arange(5)}
    ref = JPredictor(jmodel, variables["params"], variables["batch_stats"],
                     batch_size=4, return_probs=False)(**inputs, **extra)
    out = Predictor(port, batch_size=4, return_probs=False)(**inputs, **extra)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_preprocess_is_merged_into_inputs(models):
    jmodel, variables, port = models
    inputs = _inputs(3, seed=4)
    ref = JPredictor(jmodel, variables["params"], variables["batch_stats"],
                     batch_size=4, preprocess=lambda d: {"pw": d["pw"] * 0.5}
                     )(**inputs)
    out = Predictor(port, batch_size=4,
                    preprocess=lambda d: {"pw": d["pw"] * 0.5})(**inputs)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_float64_inputs_serve_as_float32(models):
    """numpy float64 inputs go through ``__call__`` and ``benchmark`` as
    float32, as the JAX ``Predictor``'s ``jnp.asarray`` (x64 off) makes
    them."""
    jmodel, variables, port = models
    inputs = {k: v.astype(np.float64) for k, v in _inputs(6, seed=6).items()}
    ref = JPredictor(jmodel, variables["params"], variables["batch_stats"],
                     batch_size=4)(**inputs)
    pred = Predictor(port, batch_size=4)
    out = pred(**inputs)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    stats = pred.benchmark(inputs, warmup=1, iters=2)
    assert 0 < stats["p50_ms"] <= stats["p95_ms"]


def test_pad_repeats_row_zero():
    a = {"a": np.arange(6)[:, None]}
    chunks = [_pad_chunk(a, start, 4) for start in (0, 4)]
    assert [m for _, m in chunks] == [4, 2]
    np.testing.assert_array_equal(chunks[1][0]["a"][:, 0], [4, 5, 4, 4])


def test_rows_do_not_depend_on_their_batch(models):
    pred = Predictor(models[2], batch_size=4)
    inputs = _inputs(6, seed=5)
    whole = pred(**inputs)
    alone = pred(**{k: v[5:] for k, v in inputs.items()})
    np.testing.assert_allclose(alone, whole[5:], atol=1e-6, rtol=0)


def test_temperature_must_be_positive(models):
    with pytest.raises(ValueError):
        Predictor(models[2], temperature=0.0)


def test_benchmark_on_cpu_reports_percentiles():
    model = init_weights(MultimodalEndToEnd(**NARROW, device="cpu"),
                         torch.Generator().manual_seed(0))
    stats = Predictor(model, batch_size=2).benchmark(_inputs(2, T=16),
                                                     warmup=1, iters=3)
    assert stats["batch_size"] == 2 and stats["device"] == "cpu"
    assert 0 < stats["p50_ms"] <= stats["p95_ms"]


def test_reserved_keys_copied_from_jax():
    from multimodal_eeg_fmri_tpu.train.fit import RESERVED_KEYS as J_KEYS

    assert RESERVED_KEYS == J_KEYS
