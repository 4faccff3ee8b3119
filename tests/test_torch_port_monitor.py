"""The port's monitoring modules against the JAX package's: ensemble
uncertainty, drift detection, profiling and the determinism harness.

The same numpy-seeded inputs go through both packages. Tolerances:
uncertainty terms and every drift state within 1e-6 (f32 elementwise math
in the same order), alarms and counts exactly; the drift monitor's shift
bound is the JAX test's (a 2σ shift on one feature alarms within 30
samples and names only that feature). The profiling and determinism
helpers are held to the JAX package's contracts: the same stats keys and
warmup rule, the same logging, the same pass and fail cases.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.core import determinism as j_det
from multimodal_eeg_fmri_tpu.core import profiling as j_prof
from multimodal_eeg_fmri_tpu.report import drift as j_drift
from multimodal_eeg_fmri_tpu.report import uncertainty as j_unc
from multimodal_eeg_fmri_tpu_torch.core import determinism as t_det
from multimodal_eeg_fmri_tpu_torch.core import profiling as t_prof
from multimodal_eeg_fmri_tpu_torch.report import drift as t_drift
from multimodal_eeg_fmri_tpu_torch.report import uncertainty as t_unc

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

ATOL = 1e-6


def _probs(K, n, C, seed):
    logits = np.random.default_rng(seed).standard_normal((K, n, C)) * 2.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# --- uncertainty ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "agree", "contradict"])
def test_ensemble_uncertainty_matches_jax(case):
    probs = _probs(5, 9, 3, seed=0)
    if case == "agree":
        probs = np.repeat(probs[:1], 5, axis=0)
    elif case == "contradict":
        probs = np.stack([np.eye(3, dtype=np.float32)[np.full(9, k % 3)]
                          for k in range(5)])
    want = j_unc.ensemble_uncertainty(jnp.asarray(probs))
    got = t_unc.ensemble_uncertainty(torch.from_numpy(probs))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == (9,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    assert (got["mutual_information"] >= 0).all()
    if case == "agree":
        assert float(got["mutual_information"].max()) <= ATOL
        assert float(got["disagreement"].max()) == 0.0


# --- drift ---------------------------------------------------------------------

def _jax_replay(step, state, xs):
    """The JAX step applied sample by sample, its states and outputs."""
    states, outs = [], []
    for x in xs:
        state, out = step(state, jnp.asarray(x))
        states.append(jax.tree.map(np.asarray, state))
        outs.append(jax.tree.map(np.asarray, out))
    return states, outs


def _assert_state(got, want, what):
    for g, w in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                    jax.tree.leaves(want)):
        g = g.numpy()
        if g.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


def test_ewma_and_cusum_steps_match_jax():
    r = np.random.default_rng(1)
    x = r.standard_normal((120, 3)).astype(np.float32) + 0.3
    js, ts = j_drift.ewma_init((3,)), t_drift.ewma_init((3,))
    jc, tc = j_drift.cusum_init((3,)), t_drift.cusum_init((3,))
    for i, xi in enumerate(x):
        js = j_drift.ewma_step(js, jnp.asarray(xi), alpha=0.1)
        ts = t_drift.ewma_step(ts, torch.from_numpy(xi), alpha=0.1)
        jc, ja = j_drift.cusum_step(jc, jnp.asarray(xi), k=0.5, h=2.0)
        tc, ta = t_drift.cusum_step(tc, torch.from_numpy(xi), k=0.5, h=2.0)
        _assert_state(ts, js, f"ewma {i}")
        _assert_state(tc, jc, f"cusum {i}")
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(tc.alarms.sum()) > 0
    tc2, _ = t_drift.cusum_step(tc, torch.full((3,), 9.0), reset=False)
    jc2, _ = j_drift.cusum_step(jc, jnp.full((3,), 9.0), reset=False)
    _assert_state(tc2, jc2, "no reset")


def test_drift_monitor_matches_jax_and_names_the_drifted_feature():
    """Step for step against JAX's monitor on a stream with a 2σ shift on
    feature 3: silent before it, alarming within 30 samples after it,
    naming only feature 3."""
    r = np.random.default_rng(2)
    F, T0, T1 = 8, 150, 60
    ref = r.standard_normal((5000, F)).astype(np.float32)
    stream = r.standard_normal((T0 + T1, F)).astype(np.float32)
    stream[T0:, 3] += 2.0
    kw = dict(k=0.5, h=8.0, alpha=0.05)
    j_init, j_step = j_drift.make_drift_monitor(ref.mean(0), ref.std(0), **kw)
    t_init, t_step = t_drift.make_drift_monitor(ref.mean(0), ref.std(0), **kw)
    want_states, want_outs = _jax_replay(j_step, j_init(), stream)
    state, alarms = t_init(), []
    for i, x in enumerate(stream):
        state, out = t_step(state, torch.from_numpy(x))
        _assert_state(state, want_states[i], f"sample {i}")
        _assert_state(out, want_outs[i], f"out {i}")
        alarms.append(out["per_feature"].numpy())
    alarms = np.stack(alarms)
    assert not alarms[:T0].any(), "false alarm before the shift"
    first = T0 + int(np.nonzero(alarms[T0:].any(-1))[0][0])
    assert first - T0 < 30, first - T0
    assert alarms[first, 3] and alarms[first].sum() == 1
    assert int(state.n) == T0 + T1


def test_drift_monitor_keeps_the_reference_device():
    init, step = t_drift.make_drift_monitor(torch.zeros(2), torch.ones(2))
    state, out = step(init(), np.asarray([0.1, -0.2], np.float32))
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(
        state, is_leaf=torch.is_tensor))
    assert out["alarm"].dtype == torch.bool and out["alarm"].dim() == 0


# --- profiling -----------------------------------------------------------------

class _Log:
    def __init__(self):
        self.rows = []

    def log(self, step, **values):
        self.rows.append((step, sorted(values)))


def test_step_timer_and_timed_fn_keep_jax_contracts():
    jt, tt = j_prof.StepTimer(warmup=1), t_prof.StepTimer(warmup=1)
    for _ in range(4):
        jt.time_call(lambda x: x * 2, jnp.ones(8))
        tt.time_call(lambda x: x * 2, torch.ones(8))
    with tt.step(torch.ones(2)):
        pass
    assert set(tt.stats()) == set(jt.stats())
    assert tt.stats()["n"] == jt.stats()["n"] + 1 == 4
    assert t_prof.StepTimer().stats() == j_prof.StepTimer().stats() == {}
    jl, tl = _Log(), _Log()
    jf = j_prof.timed_fn(lambda x: x + 1, jl, tag="serve")
    tf = t_prof.timed_fn(lambda x: {"y": [x + 1]}, tl, tag="serve")
    for _ in range(3):
        jf(jnp.ones(2))
        tf(torch.ones(2))
    assert tl.rows == jl.rows == [(i, ["serve_ms"]) for i in range(3)]


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(tmp_path / "prof") as prof:
        with t_prof.annotate("region"):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "region" in names
    assert any(e.key == "region" for e in prof.key_averages())


def test_memory_stats_are_none_on_the_cpu():
    assert t_prof.compiled_memory_stats(lambda x: x * 2,
                                        torch.ones(4)) is None


# --- determinism ---------------------------------------------------------------

def test_determinism_harness_passes_and_fails_as_jax():
    def pure():
        g = torch.Generator().manual_seed(0)
        return {"a": torch.randn(3, generator=g),
                "b": [torch.arange(2), torch.tensor(float("nan"))]}

    assert t_det.run_twice_and_compare(pure)
    for det in (j_det, t_det):
        state = {"n": 0}

        def impure():
            state["n"] += 1
            return [float(state["n"])]

        with pytest.raises(AssertionError, match="bitwise"):
            det.run_twice_and_compare(impure)
        flip = {"n": 0}

        def shape_changes():
            flip["n"] += 1
            return [1.0] * flip["n"]

        with pytest.raises(AssertionError, match="structure"):
            det.run_twice_and_compare(shape_changes)
    drifting = {"n": 0}

    def tiny_drift():
        drifting["n"] += 1
        return torch.tensor([1.0 + 1e-6 * drifting["n"]])

    assert t_det.run_twice_and_compare(tiny_drift, atol=1e-5)
    with pytest.raises(AssertionError):
        t_det.run_twice_and_compare(tiny_drift)
