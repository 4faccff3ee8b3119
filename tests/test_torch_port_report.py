"""The port's report modules against the JAX package's, with no fit.

Calibration (reliability curve, ECE, Brier, temperature scaling of one
model and of an ensemble, the threshold sweep and its optimum), split
conformal sets (LAC and APS scores, with and without a padding mask),
the per-fold and pooled clinical reports, and the statistical tests and
late fusion, on the same seeded numpy probabilities, logits, labels and
weights on both sides. Tolerances: 1e-5 (f32 sums in another order);
conformal sets exactly equal; the golden-section search exactly equal on a
shared objective, and a fitted temperature within 3e-3 relative with its
float64 NLL within 1e-6 of the JAX package's (the f32 NLL is flat within
one rounding over a ~2e-3 bracket of log T, where the two searches part).
The port's report entry points run on the card unless asked for the CPU.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.report import calibration as j_cal
from multimodal_eeg_fmri_tpu.report import clinical as j_clin
from multimodal_eeg_fmri_tpu.report import conformal as j_conf
from multimodal_eeg_fmri_tpu.report import stats as j_stats
from multimodal_eeg_fmri_tpu_torch.report import calibration as t_cal
from multimodal_eeg_fmri_tpu_torch.report import clinical as t_clin
from multimodal_eeg_fmri_tpu_torch.report import conformal as t_conf
from multimodal_eeg_fmri_tpu_torch.report import stats as t_stats

ATOL = 1e-5


def _inputs(n=60, classes=2, seed=0, weighted=True):
    """Logits that carry the label (a margin of 1.5 on the true class),
    their softmax, the labels and a weight mask."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, classes, n).astype(np.int32)
    logits = (2.0 * r.standard_normal((n, classes))
              + 1.5 * np.eye(classes)[labels]).astype(np.float32)
    weights = np.ones(n, np.float32)
    if weighted:
        weights[-7:] = 0.0                       # padding rows
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return logits, probs.astype(np.float32), labels, weights


def _close(got, want, atol=ATOL, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _both(fn_t, fn_j, *args, **kw):
    """(port result, JAX result) of the same call, each numpy array given
    as a tensor to the port and as a jnp array to the JAX package."""
    def convert(to):
        return ([to(a) if isinstance(a, np.ndarray) else a for a in args],
                {k: to(a) if isinstance(a, np.ndarray) else a
                 for k, a in kw.items()})

    t_args, t_kw = convert(torch.from_numpy)
    j_args, j_kw = convert(jnp.asarray)
    return fn_t(*t_args, **t_kw), fn_j(*j_args, **j_kw)


@pytest.mark.parametrize("weighted", [False, True])
def test_reliability_ece_and_brier_match_jax(weighted):
    _, probs, labels, w = _inputs(weighted=weighted)
    w = w if weighted else None
    p1 = probs[:, 1]
    got, want = _both(t_cal.reliability_curve, j_cal.reliability_curve, p1,
                      labels, n_bins=7, weights=w)
    for k in want:
        _close(got[k], want[k], what=k)   # NaN bins compare equal
    for name in ("expected_calibration_error", "brier_score"):
        got, want = _both(getattr(t_cal, name), getattr(j_cal, name), p1,
                          labels, weights=w)
        assert got.dtype == torch.float32
        _close(got, want, what=name)
    # a probability of exactly 1.0 lands in the last bin on both sides
    ones = np.array([1.0, 0.0, 0.55], np.float32)
    got, want = _both(t_cal.reliability_curve, j_cal.reliability_curve, ones,
                      np.array([1, 0, 1], np.int32))
    _close(got["count"], want["count"])


def _nll64(logits, labels, w, t, ensemble=False):
    """The weighted NLL of temperature ``t``, in float64."""
    z = torch.from_numpy(logits).double() / float(t)
    y = torch.from_numpy(labels).long()
    if ensemble:
        p = torch.softmax(z, -1).mean(0)
        picked = torch.log(p.gather(-1, y[:, None])[:, 0] + 1e-9)
    else:
        picked = torch.log_softmax(z, -1).gather(-1, y[:, None])[:, 0]
    w = torch.from_numpy(w).double()
    return (-(w * picked).sum() / w.sum()).item()


def test_golden_section_steps_match_jax():
    """The search alone, on an objective both frameworks round alike: the
    same brackets step for step, so the same minimum to the bit."""
    for centre in (-3.7, 0.3, 2.2):
        got = t_cal._golden_min(lambda u: (u - centre) ** 2, 4.0, 48, "cpu")
        want = j_cal._golden_min(lambda u: (u - centre) ** 2, 4.0, 48)
        assert got.item() == float(want)


@pytest.mark.parametrize("scale", [0.3, 1.0, 6.0])
def test_fit_temperature_matches_jax(scale):
    """The fitted temperatures of one model and of an ensemble. The two
    searches take the same steps until the two f32 NLLs at the bracket's
    points come within one rounding of each other (measured: a bracket
    ~2e-3 wide in log T, after ~17 steps); inside that flat bottom each
    picks its own point. Measured on these inputs: relative gaps of 8e-5
    to 1.4e-3 (the largest: the ensemble at scale 1), so T is held to
    3e-3 relative, about twice that; and the two Ts are equally good:
    their float64 NLLs agree within 1e-6."""
    logits, _, labels, w = _inputs(classes=3, seed=1)
    members = np.stack([_inputs(classes=3, seed=s)[0] for s in (1, 2, 3)])
    for fn_t, fn_j, z, ensemble in (
            (t_cal.fit_temperature, j_cal.fit_temperature, logits, False),
            (t_cal.fit_temperature_ensemble, j_cal.fit_temperature_ensemble,
             members, True)):
        got, want = _both(fn_t, fn_j, scale * z, labels, weights=w)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=3e-3)
        assert abs(_nll64(scale * z, labels, w, got.item(), ensemble)
                   - _nll64(scale * z, labels, w, float(want), ensemble)
                   ) <= 1e-6


@pytest.mark.parametrize("metric", ["f1", "youden"])
def test_threshold_sweep_and_optimum_match_jax(metric):
    _, probs, labels, w = _inputs(seed=2)
    ts = np.linspace(0.0, 1.0, 23).astype(np.float32)
    got, want = _both(t_cal.threshold_sweep, j_cal.threshold_sweep,
                      probs[:, 1], labels, ts, weights=w)
    for k in want:
        _close(got[k], want[k], what=k)
    got, want = _both(t_cal.optimal_threshold, j_cal.optimal_threshold,
                      probs[:, 1], labels, metric=metric, weights=w)
    _close(got[0], want[0], what="threshold")
    _close(got[1], want[1], what=metric)


@pytest.mark.parametrize("method", ["lac", "aps"])
@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.3])
def test_conformal_matches_jax(method, alpha):
    _, probs, labels, w = _inputs(classes=3, seed=3)
    _, test_probs, test_labels, test_w = _inputs(n=25, classes=3, seed=4)
    for weights in (None, w):
        q_t, q_j = _both(t_conf.conformal_calibrate, j_conf.conformal_calibrate,
                         probs, labels, alpha=alpha, method=method,
                         weights=weights)
        _close(q_t, q_j, what="qhat")
        sets_t = t_conf.conformal_sets(torch.from_numpy(test_probs), q_t,
                                       method)
        sets_j = j_conf.conformal_sets(jnp.asarray(test_probs), q_j, method)
        np.testing.assert_array_equal(sets_t.numpy(), np.asarray(sets_j))
        got, want = _both(t_conf.coverage_and_size, j_conf.coverage_and_size,
                          sets_t.numpy(), test_labels, weights=test_w)
        for g, x in zip(got, want):
            _close(g, x)
    # an all-masked calibration set fails conservative: full sets
    q_t, q_j = _both(t_conf.conformal_calibrate, j_conf.conformal_calibrate,
                     probs, labels, alpha=alpha, method=method,
                     weights=np.zeros_like(w))
    assert q_t.item() == float(q_j) == np.inf


def _cv_outputs(n_folds, n_test, seed):
    """What a CVResult carries for the reports: per-fold test outputs with
    padding rows."""
    r = np.random.default_rng(seed)
    probs = np.stack([_inputs(n_test, seed=seed + f)[1]
                      for f in range(n_folds)])
    weight = (r.uniform(size=(n_folds, n_test)) > 0.2).astype(np.float32)
    weight[:, 0] = 1.0
    return types.SimpleNamespace(
        test_probs=probs, test_labels=r.integers(0, 2, (n_folds, n_test)),
        test_weight=weight)


@pytest.mark.parametrize("n_folds", [1, 5])
def test_clinical_report_matches_jax(n_folds):
    result = _cv_outputs(n_folds, 14, seed=5)
    got = t_clin.clinical_report(result, device="cpu")
    want = j_clin.clinical_report(result)
    assert got.keys() == want.keys() and got["alpha"] == want["alpha"]
    assert got["per_fold"].keys() == want["per_fold"].keys()
    for k, v in want["per_fold"].items():
        _close(got["per_fold"][k], v, what=k)
        _close(got["summary"][k], want["summary"][k], what=k)


def test_pooled_clinical_report_matches_jax():
    _, probs, labels, _ = _inputs(n=32, seed=6)
    got = t_clin.pooled_clinical_report(probs, labels, alpha=0.2,
                                        device="cpu")
    want = j_clin.pooled_clinical_report(probs, labels, alpha=0.2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        _close(got[k], v, what=k)


def test_stats_and_late_fusion_match_jax():
    r = np.random.default_rng(7)
    a, b = r.uniform(0.5, 0.9, 5), r.uniform(0.5, 0.9, 5)
    for x, y in ((a, b), (a, a)):   # all differences zero: NaN t, p
        np.testing.assert_equal(t_stats.paired_tests(x, y),
                                j_stats.paired_tests(x, y))
    models = {name: _cv_outputs(3, 10, seed)
              for name, seed in (("m1", 8), ("m2", 9))}
    for res in models.values():
        res.n_folds = 3
        res.fold_metrics = {"f1": r.uniform(0.5, 0.9, 3)}
        res.test_labels = models["m1"].test_labels
        res.test_weight = models["m1"].test_weight
    assert t_stats.compare_models(models) == j_stats.compare_models(models)
    probs = [m.test_probs[0] for m in models.values()]
    for weights in (None, [0.3, 0.7]):
        _close(t_stats.late_fusion_probs(probs, weights),
               j_stats.late_fusion_probs(probs, weights))
        got = t_stats.evaluate_late_fusion(models, ["m1", "m2"], weights,
                                          device="cpu")
        want = j_stats.evaluate_late_fusion(models, ["m1", "m2"], weights)
        assert got.keys() == want.keys()
        for k, v in want.items():
            _close(got[k], v, what=k)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_report_entry_points_default_to_the_card():
    """With no device given, arrays go to the card, as the JAX package's
    go to its default device: here, with none, every entry point raises
    instead of running on the CPU; a CPU tensor stays on the CPU."""
    _, probs, labels, w = _inputs(seed=8)
    result = _cv_outputs(2, 8, seed=8)
    calls = (
        lambda: t_clin.clinical_report(result),
        lambda: t_clin.pooled_clinical_report(probs, labels),
        lambda: t_cal.expected_calibration_error(probs[:, 1], labels),
        lambda: t_conf.conformal_calibrate(probs, labels),
        lambda: t_stats.evaluate_late_fusion(
            {"m": types.SimpleNamespace(n_folds=2, **vars(result))}, ["m"]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got = t_cal.brier_score(torch.from_numpy(probs[:, 1]), labels, weights=w)
    assert got.device.type == "cpu"
