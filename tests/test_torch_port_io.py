"""The port's host I/O against the JAX package's: the file readers
(``data/loaders.py``), the subject joiners (``data/handler.py``), the native
ingest binding (``data/native_io.py``), ``core/logging.py`` and the config
files of ``core/config.py``.

Fixtures are written as ``tests/test_loaders.py`` writes them (scipy
``savemat`` for classic .mat files, h5py for MATLAB v7.3 ERP files, pandas
for CSVs), with what the readers must handle: NaN score rows, 'subNN' and
numeric subject columns, a ``Subject`` column in a feature CSV, string and
numeric labels, the lowercase conn band name, dummy labels. Every array is
held to the JAX package's exactly. The port reads CSVs without pandas and
classic .mat files without h5py, so each case also runs with pandas and
h5py unimportable and with the native library off (the numpy path); a v7.3
file then raises an error that names h5py.
"""

import dataclasses
import importlib
import json
import sys

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.core import config as j_config
from multimodal_eeg_fmri_tpu.core import logging as j_logging
from multimodal_eeg_fmri_tpu.data import handler as j_handler
from multimodal_eeg_fmri_tpu.data import loaders as j_loaders
from multimodal_eeg_fmri_tpu.data import native_io as j_native
from multimodal_eeg_fmri_tpu_torch.core import config as t_config
from multimodal_eeg_fmri_tpu_torch.core import logging as t_logging
from multimodal_eeg_fmri_tpu_torch.data import handler as t_handler
from multimodal_eeg_fmri_tpu_torch.data import loaders as t_loaders
from multimodal_eeg_fmri_tpu_torch.data import native_io as t_native

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

BANDS = {"alpha": "Alpha", "beta": "Beta"}
FREQS = ["8_13_Hz", "13_30_Hz"]
EEG_SUBJECTS = [1, 2, 3, 4, 5, 6, 7]
FMRI_SUBJECTS = [1, 2, 3, 4, 5]


def _write_eeg(root, v73_erp: bool):
    """medical_score.csv, conn/pw/erp .mat files of subjects 1-6 (7 has a
    label and no files; 8's score is NaN); ERP of subjects 1-2 as v7.3
    (HDF5) when ``v73_erp``, else every ERP classic."""
    import pandas as pd
    from scipy.io import savemat

    r = np.random.default_rng(0)
    root.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({
        "Subject": [f"sub{i:02d}" for i in range(1, 9)],
        "Postoperative evaluation": [1, 2, 3, 4, 2, 5, 1, np.nan],
    }).to_csv(root / "medical_score.csv", index=False)
    for d in ("conn", "pw", "erp"):
        (root / d).mkdir(exist_ok=True)
    for subj in range(1, 7):
        s = f"{subj:02d}"
        for band_key, band in BANDS.items():
            for cond in ("open", "close"):
                conn = r.standard_normal((3, 153)).astype(np.float32)
                conn[0, subj] = np.nan
                # subject 5 only under the lowercase band key
                name = band_key if subj == 5 else band
                savemat(root / "conn" / f"conn_{name}_{cond}_sub{s}.mat",
                        {"conn": conn})
            for freq in FREQS:
                savemat(root / "pw" / f"powspctrm_{band_key}_{freq}_sub{s}.mat",
                        {"powspctrm": r.standard_normal((75, 20)).astype(
                            np.float32)})
                erp = r.standard_normal((18, 40)).astype(np.float32)
                erp[3, 5] = np.nan
                path = root / "erp" / f"ERP_sub{s}_{band_key}_{freq}_a.mat"
                if v73_erp and subj <= 2:
                    import h5py

                    # a v7.3 file: a 512-byte header, then HDF5
                    with h5py.File(path, "w", userblock_size=512) as hf:
                        g = hf.create_group("erp_struct" if subj == 1
                                            else "erp")
                        if subj == 1:
                            g.create_dataset("avg", data=erp)
                        else:
                            g.create_dataset("trial", data=np.stack(
                                [erp, 2 * erp, erp]))
                else:
                    savemat(path, {"erp": erp})


def _write_fmri(root):
    """Five subjects' activation and connectivity CSVs (subject 3's DMN
    activation with a Subject column and a NaN, subject 5 without
    connectivity), string and numeric label files."""
    import pandas as pd

    r = np.random.default_rng(1)
    for subj in FMRI_SUBJECTS:
        d = root / f"sub-{subj}"
        d.mkdir(parents=True)
        for act in ("sensory", "DMN"):
            df = pd.DataFrame(r.standard_normal((5, 9)).astype(np.float32))
            if subj == 3 and act == "DMN":
                df.iloc[1, 2] = np.nan
                df.insert(0, "Subject", subj)
            df.to_csv(d / f"subject_{subj}_activation_{act}.csv", index=False)
        if subj != 5:
            pd.DataFrame(r.standard_normal((4, 4)).astype(np.float32)).to_csv(
                d / f"subject_{subj}_fdr_PPI_Connectivity_DMN.csv",
                index=False)
    labels = root / "DATA" / "labels"
    labels.mkdir(parents=True)
    pd.DataFrame({"Subject": [1, 2, 3, 4, 5, 9], "Label": [0, 1, 0, 1, 1, 0],
                  "Score": [1.5, 3.0, 2.0, -1.0, 0.25, 9.0]}).to_csv(
        labels / "labels.csv", index=False)
    strings = root / "string_labels"
    strings.mkdir()
    pd.DataFrame({"subject_id": [1, 2, 3, 4, 5],
                  "Outcome": ["good", "bad", "Yes", "1", "no"]}).to_csv(
        strings / "outcomes.csv", index=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    _write_eeg(root / "eeg", v73_erp=True)
    _write_eeg(root / "eeg_classic", v73_erp=False)
    numeric = root / "numeric_labels"
    numeric.mkdir()
    import pandas as pd

    pd.DataFrame({"Subject": [3, 1, 2, 4],
                  "Postoperative evaluation": [np.nan, 3.0, 2.0, 2.5]}
                 ).to_csv(numeric / "medical_score.csv", index=False)
    _write_fmri(root / "fmri")
    return root


def _read_eeg(mod, handler, root):
    labels = mod.load_eeg_labels(root)
    subjects = sorted(labels)
    conn = mod.load_eeg_conn_features(root / "conn", subjects, BANDS,
                                      ["open", "close"])
    pw = mod.load_eeg_pw_features(root / "pw", subjects, list(BANDS), FREQS)
    erp = mod.load_eeg_erp_features(root / "erp", subjects, list(BANDS),
                                    FREQS)
    arrays = handler.build_trimodal_arrays(erp, pw, conn, labels,
                                           time_steps=32)
    samples = handler.build_sample_level_arrays(erp, pw, conn, labels,
                                                time_steps=32)
    return dict(labels=labels, conn=conn, pw=pw, erp=erp, arrays=arrays,
                samples=samples)


def _read_fmri(mod, handler, root):
    act = mod.load_fmri_activation_features(root, FMRI_SUBJECTS,
                                            ["sensory", "DMN"], "both")
    act_mean = mod.load_fmri_activation_features(root, FMRI_SUBJECTS,
                                                 ["DMN"], "mean")
    conn = mod.load_fmri_connectivity_features(root, FMRI_SUBJECTS, ["DMN"])
    cls, reg = mod.load_fmri_labels(root / "DATA" / "labels", FMRI_SUBJECTS)
    strings = mod.load_fmri_labels(root / "string_labels", FMRI_SUBJECTS)
    dummy = mod.load_fmri_labels(root / "nowhere", FMRI_SUBJECTS, seed=3)
    return dict(act=act, act_mean=act_mean, conn=conn, cls=cls, reg=reg,
                strings=strings, dummy=dummy,
                arrays=handler.build_fmri_arrays(act, conn, cls, reg))


def _assert_same(got, want, where=""):
    """Equal trees: dicts with equal keys, arrays equal in shape, dtype and
    value, other leaves equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.shape == want.shape and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


@pytest.fixture(scope="module")
def jax_read(files):
    return {"eeg": _read_eeg(j_loaders, j_handler, files / "eeg"),
            "eeg_classic": _read_eeg(j_loaders, j_handler,
                                     files / "eeg_classic"),
            "numeric": j_loaders.load_eeg_labels(files / "numeric_labels"),
            "numeric_raw": j_loaders.load_eeg_labels(files / "numeric_labels",
                                                     binary=False),
            "fmri": _read_fmri(j_loaders, j_handler, files / "fmri"),
            "feature_csv": j_loaders._read_feature_csv(
                files / "fmri" / "sub-3" / "subject_3_activation_DMN.csv")}


@pytest.fixture(params=["native", "numpy"])
def ingest(request, monkeypatch):
    """The port's ingest path: the native library, or the numpy fallback
    (the library off)."""
    if request.param == "numpy":
        monkeypatch.setattr(t_native, "_LIB", None)
        monkeypatch.setattr(t_native, "_TRIED", True)
    else:
        assert t_native.native_available()
    return request.param


@pytest.fixture(params=["with", "without"])
def optional_deps(request, monkeypatch):
    """pandas and h5py importable, or not (as on the card's machine)."""
    if request.param == "without":
        for name in ("pandas", "h5py"):
            monkeypatch.setitem(sys.modules, name, None)
    return request.param


def test_eeg_readers_match_jax(files, jax_read, ingest, optional_deps):
    want = jax_read["eeg"]
    if optional_deps == "without":
        with pytest.raises(ImportError, match="h5py"):
            t_loaders.load_eeg_erp_features(files / "eeg" / "erp", [1],
                                            list(BANDS), FREQS)
        got = _read_eeg(t_loaders, t_handler, files / "eeg_classic")
        want = jax_read["eeg_classic"]
    else:
        got = _read_eeg(t_loaders, t_handler, files / "eeg")
    assert want["labels"] == {1: 0, 2: 0, 3: 1, 4: 1, 5: 0, 6: 1, 7: 0}
    assert want["arrays"]["erp"].shape == (6, 32, 18)
    _assert_same(got, want)


def test_eeg_labels_numeric_subjects(files, jax_read, optional_deps):
    got = t_loaders.load_eeg_labels(files / "numeric_labels")
    assert got == jax_read["numeric"] == {1: 1, 2: 0, 4: 1}
    raw = t_loaders.load_eeg_labels(files / "numeric_labels", binary=False)
    assert raw == jax_read["numeric_raw"] == {1: 3.0, 2: 2.0, 4: 2.5}


def test_fmri_readers_match_jax(files, jax_read, ingest, optional_deps):
    got = _read_fmri(t_loaders, t_handler, files / "fmri")
    want = jax_read["fmri"]
    assert sorted(want["conn"]) == [1, 2, 3, 4]
    assert want["strings"][0] == {1: 1, 2: 0, 3: 1, 4: 1, 5: 0}
    _assert_same(got, want)


def test_feature_csv_subject_column_and_nan(files, jax_read, ingest,
                                           optional_deps):
    """The Subject column is dropped and the NaN read as 0, as pandas'
    reader does in the JAX package."""
    fp = files / "fmri" / "sub-3" / "subject_3_activation_DMN.csv"
    got = t_loaders._read_feature_csv(fp)
    want = jax_read["feature_csv"]
    assert got.shape == (5, 9) and got[1, 2] == 0.0
    _assert_same(got, want)


def test_csv_table_follows_pandas(tmp_path):
    """``_read_csv_table`` types and names columns as ``pandas.read_csv``:
    NA strings, ints, floats, strings, an empty and a repeated name."""
    import pandas as pd

    p = tmp_path / "t.csv"
    p.write_text(",a,a,b,c,d\n0,1,2.5,x,NA,7\n1,3,,y,4,8\n\n2,5,1e3,z,,9\n")
    names, table = t_loaders._read_csv_table(p)
    df = pd.read_csv(p)
    assert names == list(df.columns)
    for name in names:
        col = df[name]
        for got, want in zip(table[name], col.tolist()):
            if isinstance(want, float) and np.isnan(want):
                assert np.isnan(got), name
            else:
                assert got == want and type(got) is type(want), (name, got)
        assert all(isinstance(x, int) for x in table[name]) == (
            col.dtype.kind == "i"), name


def test_native_io_matches_jax(files, tmp_path):
    """The port's binding and the JAX package's, on the same library and
    files: every entry point's arrays equal."""
    assert t_native.native_available() and j_native.native_available()
    csvs = sorted((files / "fmri").glob("sub-*/*.csv"))
    mats = sorted((files / "eeg_classic").glob("*/*.mat"))[:12]
    for a, b in zip(t_native.read_csv_batch(csvs),
                    j_native.read_csv_batch(csvs)):
        _assert_same(a, b)
    for p in csvs[:3]:
        _assert_same(t_native.read_csv_f32(p), j_native.read_csv_f32(p))
        # the guessing mode of the numpy path is the JAX package's
        _assert_same(t_native._numpy_csv(p, skip_header=0),
                     j_native._numpy_csv(p))
        # the default mode reads what the native parser reads
        _assert_same(t_native._numpy_csv(p), t_native.read_csv_f32(p))
    for a, b in zip(t_native.read_mat_batch(mats),
                    j_native.read_mat_batch(mats)):
        _assert_same(a, b)
    _assert_same(t_native.read_mat_f32(mats[0]), j_native.read_mat_f32(mats[0]))
    assert t_native.read_mat_f32(next(
        (files / "eeg" / "erp").glob("ERP_sub01_*"))) is None   # v7.3
    raw = np.arange(10, dtype=np.float32)
    raw.tofile(tmp_path / "x.f32")
    _assert_same(t_native.read_f32_binary(tmp_path / "x.f32"), raw)


def test_native_build_is_private_then_renamed(tmp_path):
    """``_build`` runs the repo's Makefile into a private directory, loads
    the library from there and renames it into place: ABI 2."""
    import ctypes

    so = tmp_path / "build" / "libfastio.so"
    lib = t_native._build(so)
    assert [p.name for p in so.parent.iterdir()] == ["libfastio.so"]
    lib.fio_abi_version.restype = ctypes.c_int64
    assert lib.fio_abi_version() == t_native._ABI_VERSION == 2
    again = ctypes.CDLL(str(so))
    again.fio_abi_version.restype = ctypes.c_int64
    assert again.fio_abi_version() == 2


def test_metrics_logger_round_trips(tmp_path):
    """The same series logged into both packages' ``MetricsLogger`` (the
    port's with tensors): equal series and latest values, equal JSONL and
    CSV files but for the clock column."""
    loggers = {"port": t_logging.MetricsLogger(),
               "jax": j_logging.MetricsLogger()}
    for step in range(4):
        loggers["port"].log(step, loss=torch.tensor(1.0 / (step + 1)),
                            f1=0.25 * step)
        loggers["jax"].log(step, loss=np.float32(1.0 / (step + 1)),
                           f1=0.25 * step)
    rows = {}
    for name, lg in loggers.items():
        lg.to_jsonl(tmp_path / name / "m.jsonl")
        lg.to_csv(tmp_path / name / "m.csv")
        lines = (tmp_path / name / "m.jsonl").read_text().splitlines()
        recs = [json.loads(x) for x in lines]
        csv_rows = [r.split(",") for r in
                    (tmp_path / name / "m.csv").read_text().splitlines()]
        rows[name] = ([(r["tag"], r["step"], r["value"]) for r in recs],
                      [r[:2] + r[3:] for r in csv_rows])
        assert lg.latest("f1") == 0.75 and np.isnan(lg.latest("none"))
    assert rows["port"] == rows["jax"]
    assert loggers["port"].series("loss") == loggers["jax"].series("loss")
    logger = t_logging.get_logger("mmef-port-test", log_dir=str(tmp_path))
    assert t_logging.get_logger("mmef-port-test") is logger
    assert len(logger.handlers) == 2


def _experiment(mod):
    cfg = mod.ExperimentConfig()
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, learning_rate=3e-4, seed=5,
                                  compute_dtype="bfloat16"),
        eeg=dataclasses.replace(cfg.eeg, hidden_dim=96, time_steps=512,
                                freq_bands={"alpha": (8.0, 13.0)}),
        fmri=dataclasses.replace(cfg.fmri, subjects=tuple(range(1, 9))),
        output_dir="/results/run")


def _tree(cfg):
    return j_config._to_dict(cfg)


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_config_files_cross_packages(tmp_path, monkeypatch, fmt):
    """The port's ``save_config`` (YAML with PyYAML, JSON without) read by
    the JAX package's ``load_config``, and the JAX package's file by the
    port's, each equal to the config written."""
    cfg = _experiment(t_config)
    path = tmp_path / f"cfg.{fmt}"
    with monkeypatch.context() as mp:
        if fmt == "json":
            mp.setitem(sys.modules, "yaml", None)
        t_config.save_config(cfg, path)
        if fmt == "json":
            json.loads(path.read_text())
        assert _tree(t_config.load_config(path)) == _tree(cfg)
    assert _tree(j_config.load_config(path)) == _tree(cfg)
    j_path = tmp_path / "jax.yaml"
    j_config.save_config(_experiment(j_config), j_path)
    assert _tree(t_config.load_config(j_path)) == _tree(cfg)


def test_config_yaml_without_pyyaml_raises(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    j_config.save_config(_experiment(j_config), path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="PyYAML"):
        t_config.load_config(path)
    empty = tmp_path / "empty.json"
    empty.write_text("")
    assert _tree(t_config.load_config(empty)) == _tree(
        t_config.ExperimentConfig())


def test_config_module_has_jax_fields():
    for name in ("TrainConfig", "EEGConfig", "FMRIConfig", "BridgeConfig",
                 "MeshConfig", "ExperimentConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(t_config, name))]
                == [f.name for f in dataclasses.fields(
                    getattr(j_config, name))]), name
    assert importlib.import_module(
        "multimodal_eeg_fmri_tpu_torch.core").load_config is (
        t_config.load_config)


def test_csv_writer_writes_pandas_bytes(tmp_path):
    """The port's CSV writer (no pandas) against ``pandas.DataFrame(rows)
    .to_csv(index=False)``: ints, floats, NaN and missing keys, bools,
    strings with commas and quotes, numpy scalars, an all-missing column."""
    import pandas as pd

    from multimodal_eeg_fmri_tpu_torch.report import export as t_export

    rows = [{"model": "a,b", "fold": 0, "value": 0.1, "ok": True,
             "n": np.int64(3), "x": np.float64(1e-20), "note": 'say "hi"'},
            {"model": "c", "fold": 1, "value": float("nan"), "ok": False,
             "n": np.int64(-4), "x": 2.5, "extra": 7},
            {"model": "d", "fold": 2, "value": 3, "ok": True, "n": 5,
             "x": -0.0, "none": None}]
    t_export._write_csv(tmp_path / "port.csv", rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "pandas.csv").read_bytes())


def test_config_json_overlay_reads_exponent_floats(tmp_path):
    """A hand-written JSON overlay with "1e-5" gives a float in the port,
    read as JSON first (PyYAML's YAML 1.1 rules read it as a string)."""
    path = tmp_path / "overlay.json"
    path.write_text('{"train": {"weight_decay": 1e-5, "num_epochs": 3}, '
                    '"output_dir": "out"}')
    cfg = t_config.load_config(path)
    assert cfg.train.weight_decay == 1e-5 and cfg.train.num_epochs == 3
    assert cfg.output_dir == "out" and cfg.eeg == t_config.EEGConfig()
