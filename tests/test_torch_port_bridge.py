"""The port's two-stage bridge pipeline against the JAX package's.

Stage-1 extraction (``extract_fused_features``) of the narrow
``TriModalFusionNetV4`` (hidden 32, one layer, two heads) at T=32 and, on
the flash route, T=512 (the JAX kernel in interpret mode), and of
``FMRIFusionNet``, with several samples a subject; the int-coerced
alignment; and ``run_bridge_loocv`` on a narrow ``BridgeFusionNet`` (bridge
16, two heads, dropout 0) over 12 synthetic subjects, 3 epochs, IG over 5
steps. Each LOOCV fold of the port starts from the flax variables the JAX
package's ``fit`` initialises from that fold's key
(``initial_variables=``), the batch holds the whole padded fold, so the
shuffle only permutes rows inside it, and the fusion gate's fixed dropout
is off on both sides, as in ``test_torch_port_cv.py``. The JAX run is
module-scoped.

Tolerances: embeddings within 1e-5 of the largest (one forward and an f64
mean); pooled metrics, the held-out probabilities, the records' weights and
the clinical values within 1e-4 (whole fits, many f32 sums in another
order), subjects, labels and predictions equal; the per-fold saliency and IG
arrays within 1e-4 of the largest JAX value.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
from test_torch_port_cv import _fold_variables, _port_cfg, flax_dropout_off
from test_torch_port_train import flash_counts  # noqa: F401 (a fixture)
from test_torch_port_xai import TRI, assert_rel, eeg_inputs, pair

from multimodal_eeg_fmri_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_eeg_fmri_tpu.data import synthetic as j_synthetic
from multimodal_eeg_fmri_tpu.models.bridge import BridgeFusionNet as JBridge
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu.models.fmri import FMRIFusionNet as JFMRI
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4 as TTri
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet as TFMRI
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion

j_flow = importlib.import_module("multimodal_eeg_fmri_tpu.train.bridge_flow")
t_flow = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.train.bridge_flow")
j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")

BRIDGE = dict(bridge_dim=16, num_heads=2, dropout=0.0)
N_SUBJECTS, IG_STEPS, ATOL = 12, 5, 1e-4


# --- stage 1: extraction and alignment ----------------------------------

def _fmri_inputs(n, seed=0):
    r = np.random.default_rng(seed)
    return dict(activation=r.standard_normal((n, 90)).astype(np.float32),
                connectivity=r.standard_normal((n, 64)).astype(np.float32))


@pytest.mark.parametrize("case", ["tri_T32", "tri_T512", "fmri"])
def test_extract_fused_features_matches_jax(case, flash_counts):
    """12 samples of 4 subjects (ids 7, 3, 9, 5, three samples each, out of
    order); at T=512 the ERP and PW layers take the flash route."""
    if case == "fmri":
        inputs = _fmri_inputs(12, seed=1)
        fmod, variables, port = pair(JFMRI(hidden_dim=16, dropout=0.0),
                                     TFMRI(hidden_dim=16, dropout=0.0,
                                           device="cpu"), inputs, seed=3)
    else:
        T = 512 if case == "tri_T512" else 32
        inputs = eeg_inputs(12, T, seed=2)
        fmod, variables, port = pair(JTri(**TRI), TTri(**TRI, device="cpu"),
                                     eeg_inputs(2, 32), seed=4)
    data = {**inputs, "label": np.arange(12, dtype=np.int32) % 2,
            "subject": np.repeat(np.array([7, 3, 9, 5], np.int32), 3)}
    subj_t, feats_t = t_flow.extract_fused_features(port, None, None, data)
    subj_j, feats_j = j_flow.extract_fused_features(
        fmod, variables["params"], variables.get("batch_stats"), data)
    np.testing.assert_array_equal(subj_t, subj_j)
    np.testing.assert_array_equal(subj_t, [3, 5, 7, 9])
    assert feats_t.dtype == feats_j.dtype == np.float32
    assert_rel(feats_t, feats_j, 1e-5, case)
    flash = 2 if case == "tri_T512" else 0
    assert flash_counts["port_fwd"] == flash and flash_counts["port_bwd"] == 0


def test_align_bridge_dataset_matches_jax():
    """String ids coerce to ints ('001' is subject 1), the overlap of the
    three maps is sorted, and no overlap raises."""
    r = np.random.default_rng(5)
    eeg_s = np.array(["001", "2", "5", "7"])
    fmri_s = np.array([7, 1, 5, 8])
    eeg_f, fmri_f = r.random((4, 6)), r.random((4, 3))
    labels = {"1": 0, 5: 1, 7: 1, 8: 0}
    got = t_flow.align_bridge_dataset(eeg_s, eeg_f, fmri_s, fmri_f, labels)
    want = j_flow.align_bridge_dataset(eeg_s, eeg_f, fmri_s, fmri_f, labels)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["subject"], [1, 5, 7])
    for mod in (t_flow, j_flow):
        with pytest.raises(ValueError, match="no subjects aligned"):
            mod.align_bridge_dataset(np.array([1, 2]), np.zeros((2, 8)),
                                     np.array([3, 4]), np.zeros((2, 8)),
                                     {5: 0})


# --- stage 2: the bridge LOOCV ------------------------------------------

def _bridge_data():
    return j_synthetic.synthetic_bridge(n_subjects=N_SUBJECTS, eeg_dim=12,
                                        fmri_dim=8, separation=1.5, seed=6)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's ``run_bridge_loocv`` and the port's, each fold of
    the port started from the JAX fold's initial variables."""
    data = _bridge_data()
    splits = j_cv.loocv_splits(data)
    rows = N_SUBJECTS - 1
    cfg = JTrainConfig(batch_size=rows, num_epochs=3, learning_rate=3e-3,
                       weight_decay=1e-4, selection="train_loss", seed=7)
    with flax_dropout_off():
        res_j = j_flow.run_bridge_loocv(data, cfg, ig_steps=IG_STEPS,
                                        **BRIDGE)
        stack = j_cv.build_fold_arrays(data, splits, "none")[0]
        variables = _fold_variables(JBridge(eeg_dim=12, fmri_dim=8, **BRIDGE),
                                    cfg.seed, stack, rows)

    def bridge_without_gate_dropout(**kw):
        model = BridgeFusionNet(**kw)
        for m in model.modules():
            if isinstance(m, LearnedFusion):
                m.gate_dropout = 0.0
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_flow, "BridgeFusionNet", bridge_without_gate_dropout)
        res_t = t_flow.run_bridge_loocv(data, _port_cfg(cfg), ig_steps=IG_STEPS,
                                        device="cpu",
                                        initial_variables=variables, **BRIDGE)
    return res_t, res_j


def test_bridge_loocv_metrics_and_probs_match_jax(runs):
    res_t, res_j = runs
    assert res_t.cv.n_folds == res_j.cv.n_folds == N_SUBJECTS
    np.testing.assert_allclose(res_t.cv.test_probs, res_j.cv.test_probs,
                               atol=ATOL, rtol=0)
    for k in ("train_loss",):
        np.testing.assert_allclose(res_t.cv.history[k], res_j.cv.history[k],
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(res_t.cv.best_epochs, res_j.cv.best_epochs)
    assert res_t.loocv_metrics.keys() == res_j.loocv_metrics.keys()
    for k, v in res_j.loocv_metrics.items():
        np.testing.assert_allclose(res_t.loocv_metrics[k], v, atol=ATOL,
                                   rtol=0, err_msg=k)
    assert res_t.clinical.keys() == res_j.clinical.keys()
    for k, v in res_j.clinical.items():
        np.testing.assert_allclose(res_t.clinical[k], v, atol=ATOL, rtol=0,
                                   err_msg=k)


def test_bridge_loocv_records_match_jax(runs):
    res_t, res_j = runs
    assert len(res_t.per_subject) == len(res_j.per_subject) == N_SUBJECTS
    for got, want in zip(res_t.per_subject, res_j.per_subject):
        assert got.keys() == want.keys()
        for k in ("subject", "label", "prediction"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["prob_class1"], want["prob_class1"],
                                   atol=ATOL, rtol=0)
        for k in ("fusion_weights", "attn_weights"):
            assert got[k].shape == np.shape(want[k]) == (2,)
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


def test_bridge_loocv_xai_matches_jax(runs):
    """Saliency and IG of each held-out subject under its fold's best
    params, (12, 12) and (12, 8)."""
    res_t, res_j = runs
    assert list(res_t.xai) == list(res_j.xai) == [
        "saliency_eeg", "saliency_fmri", "ig_eeg", "ig_fmri"]
    for k, want in res_j.xai.items():
        assert res_t.xai[k].shape == (N_SUBJECTS, 12 if "eeg" in k else 8)
        assert_rel(res_t.xai[k], want, ATOL, k)


def test_bridge_loocv_xai_is_the_attributions_of_each_fold(runs):
    """The per-fold XAI equals the attribution functions applied by hand to
    fold 3's best params, exactly."""
    from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
        gradient_saliency,
        integrated_gradients,
        make_apply_fn,
    )

    res_t, _ = runs
    data, f = _bridge_data(), 3
    model = BridgeFusionNet(eeg_dim=12, fmri_dim=8, device="cpu", **BRIDGE)
    apply_fn = make_apply_fn(model, {k: v[f] for k, v in
                                     res_t.cv.params.items()},
                             {k: v[f] for k, v in
                              res_t.cv.batch_stats.items()})
    inputs = {k: torch.as_tensor(data[k][f:f + 1]) for k in ("eeg", "fmri")}
    sal = gradient_saliency(apply_fn, inputs)
    ig = integrated_gradients(apply_fn, inputs, n_steps=IG_STEPS)
    for k in ("eeg", "fmri"):
        np.testing.assert_array_equal(res_t.xai[f"saliency_{k}"][f],
                                      sal[k][0].numpy())
        np.testing.assert_array_equal(res_t.xai[f"ig_{k}"][f],
                                      ig[k][0].numpy())


def test_bridge_loocv_defaults_and_without_xai(monkeypatch):
    """The defaults are the JAX package's (lr 1e-4, wd 1e-4, selection on
    train loss, no normalization); ``with_xai=False`` skips the XAI."""
    seen = {}

    def run_cv(model, cfg, data, splits, **kw):
        seen.update(cfg=cfg, kw=kw, model=model, n=len(splits))
        raise InterruptedError

    monkeypatch.setattr(t_flow, "run_cv", run_cv)
    with pytest.raises(InterruptedError):
        t_flow.run_bridge_loocv(_bridge_data(), device="cpu")
    want = dataclasses.replace(TrainConfig(), learning_rate=1e-4,
                               weight_decay=1e-4, selection="train_loss")
    assert seen["cfg"] == want and seen["n"] == N_SUBJECTS
    assert seen["kw"] == {"normalize": "none", "initial_variables": None}
    m = seen["model"]
    assert (m.eeg_proj.dense.in_features, m.fmri_proj.dense.in_features,
            m.eeg_proj.dense.out_features, m.cross_attn.num_heads,
            m.dropout) == (12, 8, 128, 4, 0.3)
    assert next(m.parameters()).device.type == "cpu"
    monkeypatch.undo()

    cfg = TrainConfig(batch_size=N_SUBJECTS - 1, num_epochs=1,
                      selection="train_loss")
    res = t_flow.run_bridge_loocv(_bridge_data(), cfg, device="cpu",
                                  with_xai=False, **BRIDGE)
    assert res.per_subject == [] and res.xai == {}
    assert np.all(np.isfinite(list(res.loocv_metrics.values())))
