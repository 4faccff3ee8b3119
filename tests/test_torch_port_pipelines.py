"""The port's experiment pipelines (``pipelines.py``) against the JAX
package's.

Orchestration: ``run_model_suite`` and ``run_cv`` are patched in both
packages' ``pipelines`` modules. The JAX side's stand-in returns results
made from a seeded generator over the real padded folds (fold metrics,
test probabilities, labels, weights and subjects) and draws each model's
variables in the layout of its flax init (``jax.eval_shape``); the port's
stand-in gets the same results in the port's ``CVResult``, its params
loaded from those variables into the models the port's pipeline built
(``load_flax_variables`` refuses any shape that differs from the flax
init's). With those results ``run_eeg_experiment``, ``run_fmri_experiment``
and ``run_lite_training`` give equal stats, late fusion, clinical reports,
LOSO votes and subject accuracy (1e-5, the reports' f32 math), the same
exported files byte for byte, the same splits, normalization, training
configs and dropouts. The bridge's stage-1 models are held to the flax
models ``run_bridge_experiment`` builds in the same way.

Smoke: every ``run_*`` really trains on the CPU at ``tests/
test_pipelines.py``'s tiny config, and the CLI runs ``--pipeline lite``
with a JSON ``--config`` and ``--pipeline all`` over a cohort in the
reference's file formats, with ``--cpu``; without ``--cpu`` and without a
card it raises. The number-for-number training of the pipelines' models is
held by ``test_torch_port_zoo_suite.py`` and ``test_torch_port_cv.py``.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.core import config as j_config
from multimodal_eeg_fmri_tpu.data.synthetic import (
    synthetic_eeg_trimodal,
    synthetic_fmri,
)
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core import config as t_config

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

j_pipelines = importlib.import_module("multimodal_eeg_fmri_tpu.pipelines")
t_pipelines = importlib.import_module("multimodal_eeg_fmri_tpu_torch.pipelines")
j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")
j_fit = importlib.import_module("multimodal_eeg_fmri_tpu.train.fit")
j_models = importlib.import_module("multimodal_eeg_fmri_tpu.models")
t_main = importlib.import_module("multimodal_eeg_fmri_tpu_torch.__main__")

ATOL = 1e-5


def tiny_cfg(mod, out_dir, **over):
    """``tests/test_pipelines.py``'s tiny config in package ``mod``."""
    cfg = mod.ExperimentConfig()
    train = dataclasses.replace(cfg.train, num_epochs=2, batch_size=4,
                                patience=100)
    eeg = dataclasses.replace(
        cfg.eeg, hidden_dim=16, lite_hidden_dim=16, num_heads=2,
        num_transformer_layers=1, time_steps=16, n_splits=2)
    fmri = dataclasses.replace(cfg.fmri, hidden_dim=16, fusion_dim=16,
                               n_splits=2)
    bridge = dataclasses.replace(cfg.bridge, bridge_dim=16, num_heads=2)
    return dataclasses.replace(cfg, train=train, eeg=eeg, fmri=fmri,
                               bridge=bridge, output_dir=str(out_dir), **over)


def tiny_eeg(n=12):
    return synthetic_eeg_trimodal(n_subjects=n, time_steps=16,
                                  separation=1.0, seed=0)


def tiny_fmri(n=16):
    return synthetic_fmri(n_subjects=n, seed=0)


# --- the stand-ins for run_model_suite / run_cv ------------------------------

def _outputs(data, splits, kw, seed):
    """A CV run's outputs over the real padded folds: seeded fold metrics
    and test probabilities, the folds' test labels, weights, subjects."""
    task = kw.get("task", "classification")
    normalize = kw.get("normalize", "scalar")
    stacks = j_cv.build_fold_arrays(
        {k: np.asarray(v) for k, v in data.items()}, splits, normalize,
        kw.get("normalize_keys", ()),
        weighted_classes=task == "classification")
    test = stacks[1]["test"]
    r = np.random.default_rng(seed)
    F, n = test["label"].shape
    if task == "classification":
        logits = r.standard_normal((F, n, 2)) * 2
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        names = ("accuracy", "f1", "auc")
    else:
        probs = r.standard_normal((F, n, 1))
        names = ("mse", "r2")
    fold_metrics = {k: r.uniform(0.2, 0.9, F) for k in names}
    return dict(
        fold_metrics=fold_metrics,
        summary={k: (float(np.mean(v)), float(np.std(v)))
                 for k, v in fold_metrics.items()},
        history={"train_loss": r.uniform(0.1, 1.0, (F, 2))},
        best_epochs=np.ones(F, np.int32), n_folds=F,
        test_probs=probs.astype(np.float32), test_labels=test["label"],
        test_weight=test["weight"], test_subjects=test.get("subject"))


def _flax_variables(model, data, seed):
    """Random values in the layout of ``model``'s flax init on ``data``."""
    inputs = j_fit.split_batch({k: np.asarray(v)[:2]
                                for k, v in data.items()})
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, **inputs, train=True))
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: r.standard_normal(s.shape).astype(s.dtype), shapes)


class StandIns:
    """``run_model_suite`` / ``run_cv`` for both packages: the JAX side's
    calls record (name, model, cfg, splits, kwargs, outputs, variables);
    the port side's replay them in order."""

    def __init__(self):
        self.jax_calls, self.port_calls = [], []

    def _jax_one(self, name, model, cfg, data, splits, kw):
        seed = len(self.jax_calls)
        rec = dict(name=name, model=model, cfg=cfg, splits=splits, kw=kw,
                   out=_outputs(data, splits, kw, seed),
                   variables=_flax_variables(model, data, seed))
        self.jax_calls.append(rec)
        return j_cv.CVResult(params=rec["variables"]["params"],
                             batch_stats=rec["variables"].get("batch_stats"),
                             **rec["out"])

    def _port_one(self, name, model, cfg, data, splits, kw):
        rec = self.jax_calls[len(self.port_calls)]
        assert rec["name"] == name
        self.port_calls.append(dict(name=name, model=model, cfg=cfg,
                                    splits=splits, kw=kw))
        v = rec["variables"]
        load_flax_variables(model, v["params"], v.get("batch_stats"))
        state = {k: t.detach().clone()[None]
                 for k, t in model.state_dict().items()}
        return t_cv.CVResult(params=state, batch_stats={}, **rec["out"])

    def patch(self, mp):
        def suite(one):
            return lambda models, cfg, data, splits, **kw: {
                name: one(name, m, cfg, data, splits, kw)
                for name, m in models.items()}

        mp.setattr(j_pipelines, "run_model_suite", suite(self._jax_one))
        mp.setattr(j_pipelines, "run_cv",
                   lambda m, cfg, data, splits, **kw: self._jax_one(
                       "run_cv", m, cfg, data, splits, kw))
        mp.setattr(j_pipelines, "enable_compilation_cache", lambda: None)
        mp.setattr(t_pipelines, "run_model_suite", suite(self._port_one))
        mp.setattr(t_pipelines, "run_cv",
                   lambda m, cfg, data, splits, **kw: self._port_one(
                       "run_cv", m, cfg, data, splits, kw))

    def assert_same_calls(self):
        """Equal names, splits, training configs and keyword arguments;
        each port model's dropout rates include its flax twin's and none
        exceeds it."""
        assert len(self.port_calls) == len(self.jax_calls)
        for j, t in zip(self.jax_calls, self.port_calls):
            assert j["name"] == t["name"]
            assert (dataclasses.asdict(t["cfg"])
                    == dataclasses.asdict(j["cfg"])), j["name"]
            assert len(j["splits"]) == len(t["splits"])
            for a, b in zip(j["splits"], t["splits"]):
                for part in ("train", "val", "test"):
                    np.testing.assert_array_equal(getattr(b, part),
                                                  getattr(a, part))
            jkw, tkw = dict(j["kw"]), dict(t["kw"])
            assert (jkw.pop("augment", None) is None) == (
                tkw.pop("augment", None) is None), j["name"]
            assert tkw == jkw, j["name"]
            rates = {m.dropout for m in t["model"].modules()
                     if isinstance(getattr(m, "dropout", None), float)}
            assert j["model"].dropout in rates, (j["name"], rates)
            assert max(rates) == j["model"].dropout, (j["name"], rates)


def _close_tree(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _close_tree(a, b, f"{where}[{i}]")
    else:
        got = got.numpy() if torch.is_tensor(got) else got
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=ATOL,
                                   rtol=0, err_msg=where)


def _exports(d):
    """{file name without its time tag: bytes} of a pipeline's exports."""
    return {re.sub(r"_\d+(\.\w+)$", r"\1", p.name): p.read_bytes()
            for p in sorted(d.iterdir())}


def _run_both(tmp_path, monkeypatch, fn_name, **kw):
    stand = StandIns()
    stand.patch(monkeypatch)
    outs = {}
    for name, mod, pl, extra in (
            ("jax", j_config, j_pipelines, {}),
            ("port", t_config, t_pipelines, {"device": "cpu"})):
        cfg = tiny_cfg(mod, tmp_path / name)
        outs[name] = getattr(pl, fn_name)(cfg, **kw, **extra)
    stand.assert_same_calls()
    return outs, stand


def test_eeg_experiment_matches_jax(tmp_path, monkeypatch):
    outs, stand = _run_both(tmp_path, monkeypatch, "run_eeg_experiment",
                            data=tiny_eeg(), with_loso=True, export=True)
    got, want = outs["port"], outs["jax"]
    assert [c["name"] for c in stand.port_calls] == [
        "trimodal", "fusion", "pwonly", "erponly", "run_cv"]
    assert got["stats"] == want["stats"]
    _close_tree(got["late_fusion"], want["late_fusion"], "late_fusion")
    _close_tree({k: r["per_fold"] for k, r in got["clinical"].items()},
                {k: r["per_fold"] for k, r in want["clinical"].items()},
                "clinical")
    assert got["loso"]["votes"] == want["loso"]["votes"]
    assert got["loso"]["subject_accuracy"] == want["loso"]["subject_accuracy"]
    assert set(got["export_paths"]) == {"detailed", "summary"}
    assert _exports(tmp_path / "port") == _exports(tmp_path / "jax")


def test_fmri_experiment_matches_jax(tmp_path, monkeypatch):
    outs, stand = _run_both(tmp_path, monkeypatch, "run_fmri_experiment",
                            data=tiny_fmri(), with_loso=True, export=True)
    got, want = outs["port"], outs["jax"]
    names = ["fusion", "activation_only", "connectivity_only"]
    assert [c["name"] for c in stand.port_calls] == names * 2 + ["run_cv"]
    assert [c["kw"].get("task", "classification")
            for c in stand.port_calls] == (
        ["classification"] * 3 + ["regression"] * 3 + ["classification"])
    _close_tree({k: r["per_fold"] for k, r in got["clinical"].items()},
                {k: r["per_fold"] for k, r in want["clinical"].items()},
                "clinical")
    assert set(got["regression"]) == set(names)
    assert got["loso"]["votes"] == want["loso"]["votes"]
    assert got["loso"]["subject_accuracy"] == want["loso"]["subject_accuracy"]
    assert _exports(tmp_path / "port") == _exports(tmp_path / "jax")


def test_lite_training_matches_jax(tmp_path, monkeypatch):
    outs, stand = _run_both(tmp_path, monkeypatch, "run_lite_training",
                            data=tiny_eeg(), export=True)
    (call,) = stand.port_calls
    assert call["cfg"].loss == "label_smoothing"
    assert call["kw"]["normalize_keys"] == ("erp", "pw", "conn")
    assert outs["port"]["lite"].summary == outs["jax"]["lite"].summary
    assert _exports(tmp_path / "port") == _exports(tmp_path / "jax")


def test_bridge_stage1_models_match_jax():
    """The two encoders ``run_bridge_experiment`` trains in stage 1, as the
    JAX package builds them: flax variables load into the port's models,
    and the dropouts agree."""
    eeg, fmri = tiny_eeg(), tiny_fmri()
    fmri.pop("reg_label")
    cfg = tiny_cfg(t_config, "unused")
    e = cfg.eeg
    flax_models = (
        j_models.TriModalFusionNetV4(
            hidden_dim=e.hidden_dim, dropout=e.dropout,
            num_transformer_layers=e.num_transformer_layers,
            num_heads=e.num_heads),
        j_models.FMRIFusionNet(hidden_dim=cfg.fmri.hidden_dim,
                               dropout=cfg.fmri.dropout))
    port_models = t_pipelines.bridge_stage1_models(cfg, eeg, fmri, "cpu")
    for fm, pm, data in zip(flax_models, port_models, (eeg, fmri)):
        v = _flax_variables(fm, data, 0)
        load_flax_variables(pm, v["params"], v.get("batch_stats"))
        rates = {m.dropout for m in pm.modules()
                 if isinstance(getattr(m, "dropout", None), float)}
        assert max(rates) == fm.dropout


# --- smoke: real training on the CPU ---------------------------------------

def test_pipelines_train_on_cpu(tmp_path):
    cfg = tiny_cfg(t_config, tmp_path / "out")
    eeg, fmri = tiny_eeg(), tiny_fmri()
    out = t_pipelines.run_eeg_experiment(cfg, data=eeg, with_loso=False,
                                         device="cpu")
    assert set(out["kfold"]) == {"trimodal", "fusion", "pwonly", "erponly"}
    assert all(np.isfinite(r.summary["f1"][0]) for r in out["kfold"].values())
    assert out["export_paths"]["detailed"].exists()
    out = t_pipelines.run_fmri_experiment(cfg, data=fmri, export=False,
                                          device="cpu")
    assert "regression" in out
    assert all(np.isfinite(r.summary["accuracy"][0])
               for r in out["classification"].values())
    out = t_pipelines.run_bridge_experiment(cfg, eeg_data=eeg,
                                            fmri_data=fmri, device="cpu")
    res = out["bridge"]
    assert np.isfinite(res.loocv_metrics["accuracy"])
    assert len(res.per_subject) == len(out["bridge_data"]["label"])
    assert "saliency_eeg" in res.xai
    assert len(list((tmp_path / "out").glob("bridge_subjects_*.csv"))) == 1
    out = t_pipelines.run_lite_training(cfg, data=eeg, export=False,
                                        device="cpu")
    assert np.isfinite(out["lite"].summary["f1"][0])


def test_pipelines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tiny_cfg(t_config, "unused")
    for call in (lambda: t_pipelines.run_lite_training(cfg, data=tiny_eeg()),
                 lambda: t_pipelines.run_eeg_experiment(cfg),
                 lambda: t_pipelines.run_fmri_experiment(cfg),
                 lambda: t_pipelines.run_bridge_experiment(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _write_fmri_cohort(root, n=16):
    """n subjects' activation and connectivity CSVs and a labels file in
    the reference's layout."""
    import pandas as pd

    r = np.random.default_rng(2)
    for subj in range(1, n + 1):
        d = root / f"sub-{subj}"
        d.mkdir(parents=True)
        for act in ("sensory", "AN", "LN", "cognitive", "DMN"):
            pd.DataFrame(r.standard_normal((6, 9)).astype(np.float32)).to_csv(
                d / f"subject_{subj}_activation_{act}.csv", index=False)
        pd.DataFrame(r.standard_normal((8, 8)).astype(np.float32)).to_csv(
            d / f"subject_{subj}_fdr_PPI_Connectivity_DMN.csv", index=False)
    (root / "DATA" / "labels").mkdir(parents=True)
    pd.DataFrame({"Subject": range(1, n + 1), "Label": [0, 1] * (n // 2),
                  "Score": r.standard_normal(n)}).to_csv(
        root / "DATA" / "labels" / "labels.csv", index=False)


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main.main(argv)
    return rc, json.loads(buf.getvalue())


def test_cli_lite_json_config(tmp_path, monkeypatch):
    """``--pipeline lite --cpu`` with a JSON overlay written without
    PyYAML; the JSON summary on stdout."""
    import sys

    cfg = tiny_cfg(t_config, tmp_path / "results")
    path = tmp_path / "cfg.json"
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "yaml", None)
        t_config.save_config(cfg, path)
    json.loads(path.read_text())
    rc, out = _cli(["--pipeline", "lite", "--config", str(path), "--cpu",
                    "--epochs", "2", "--seed", "3", "--no-export",
                    "--output-dir", str(tmp_path / "out")])
    assert rc == 0 and out["pipeline"] == "lite"
    assert set(out["summary"]) >= {"f1", "accuracy"}
    assert not (tmp_path / "out").exists()


def test_cli_all_on_reference_files(tmp_path):
    """``--pipeline all --cpu`` over a cohort in the reference's file
    formats (6 EEG subjects, 16 fMRI subjects), exports written."""
    from test_torch_port_io import BANDS, _write_eeg

    _write_eeg(tmp_path / "eeg", v73_erp=False)
    _write_fmri_cohort(tmp_path / "fmri")
    cfg = tiny_cfg(t_config, tmp_path / "results")
    cfg = dataclasses.replace(
        cfg,
        eeg=dataclasses.replace(cfg.eeg, data_root=str(tmp_path / "eeg"),
                                freq_bands={"alpha": (8.0, 13.0),
                                            "beta": (13.0, 30.0)}),
        fmri=dataclasses.replace(cfg.fmri, data_root=str(tmp_path / "fmri"),
                                 subjects=tuple(range(1, 17))))
    assert set(cfg.eeg.freq_bands) == set(BANDS)
    path = tmp_path / "cfg.yaml"
    t_config.save_config(cfg, path)
    rc, out = _cli(["--pipeline", "all", "--config", str(path), "--cpu"])
    assert rc == 0 and out["pipeline"] == "all"
    assert set(out["summary"]) == {"eeg", "fmri", "bridge", "lite"}
    assert set(out["summary"]["eeg"]) == {"trimodal", "fusion", "pwonly",
                                          "erponly"}
    names = sorted(re.sub(r"_\d+(\.\w+)$", r"\1", p.name)
                   for p in (tmp_path / "results").iterdir())
    assert names == ["bridge_subjects.csv", "bridge_xai.npz",
                     "eeg_detailed.csv", "eeg_summary.csv",
                     "fmri_detailed.csv", "fmri_summary.csv",
                     "lite_detailed.csv", "lite_summary.csv"]


def test_cli_refuses(tmp_path, monkeypatch):
    """The CLI refuses a run without ``--pipeline`` and, without a card, a
    run on the card; ``--aot-dir`` is no longer refused: it reaches the
    EEG and fMRI pipelines, as the JAX package's CLI passes it."""
    with pytest.raises(SystemExit):
        t_main.main([])
    seen = {}

    def fake(name, out):
        def run(cfg, export=True, aot_dir=None, device="cuda"):
            seen[name] = (aot_dir, device)
            return out
        return run

    with monkeypatch.context() as mp:
        mp.setattr(t_pipelines, "run_eeg_experiment",
                   fake("eeg", {"kfold": {}}))
        mp.setattr(t_pipelines, "run_fmri_experiment",
                   fake("fmri", {"classification": {}}))
        for pipe in ("eeg", "fmri"):
            assert t_main.main(["--pipeline", pipe, "--aot-dir",
                                str(tmp_path), "--cpu", "--no-export"]) == 0
    assert seen == {"eeg": (str(tmp_path), "cpu"),
                    "fmri": (str(tmp_path), "cpu")}
    if not torch.cuda.is_available():
        cfg_path = tmp_path / "cfg.json"
        t_config.save_config(tiny_cfg(t_config, tmp_path), cfg_path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_main.main(["--pipeline", "lite", "--config", str(cfg_path),
                         "--no-export"])
