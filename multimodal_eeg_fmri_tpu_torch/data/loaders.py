"""Host-side file readers (PyTorch port): labels CSV, .mat/HDF5 EEG
features, fMRI CSVs. Counterpart of
``multimodal_eeg_fmri_tpu/data/loaders.py``, with the same discovery rules
and results, so existing datasets drop in unchanged:

- ``load_eeg_labels``      ← ``EEG_CODE/eeg_data_utils.py:19-43``
  (medical_score.csv, 'Postoperative evaluation' ≤ 2 → 0 else 1,
  'subNN' → int subject ids)
- ``load_eeg_conn_features`` ← ``:46-83`` (``conn_{Band}_{cond}_subNN.mat``,
  first non-underscore key, NaN→0, flattened)
- ``load_eeg_pw_features``   ← ``:86-119`` (``powspctrm_{band}_{freq}_subNN.mat``)
- ``load_eeg_erp_features``  ← ``:122-186`` (``ERP_subNN_{band}_{freq}*.mat``;
  MATLAB v7.3 via h5py — 'erp_struct'/'erp' group, 'avg' or trial-mean —
  with the classic-format reader as the fallback)
- fMRI CSV loaders           ← ``fMRI_CODE/run_fmri_v11.py:81-212``
  (``sub-N/subject_N_activation_{type}.csv`` mean/std/both aggregation,
  ``subject_N_fdr_PPI_Connectivity_{type}.csv`` flattened, label-file
  discovery over column-name candidates, dummy-label fallback)

The JAX package reads its CSVs with pandas and its v7.3 files with h5py.
The card's machine has neither, so the port reads CSVs with the ``csv``
module and numpy, with pandas' semantics where the readers rely on them
(``_read_csv_table``: the first line is the header, blank lines are
skipped, pandas' default NA strings are NaN, a column is numeric when every
value in it is), and imports h5py per file: without it a classic .mat ERP
file goes through the classic reader (native, else scipy), and a v7.3 file
raises an ``ImportError`` that names h5py. All readers return plain numpy
dicts. Every file read is wrapped in try/except-with-warning like the
reference.
"""

from __future__ import annotations

import csv
import glob
import logging
import math
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# the strings pandas.read_csv reads as NaN by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _number(s: str) -> Optional[float]:
    """The float a CSV field stands for (NaN for an NA string), or None
    when it is not a number."""
    if s in _NA_STRINGS:
        return math.nan
    try:
        return float(s)
    except ValueError:
        return None


def _read_csv_table(path: str | Path) -> Tuple[List[str], Dict[str, list]]:
    """(column names, {name: values}) of a CSV as ``pandas.read_csv`` types
    it: a column whose every field is a number or an NA string holds
    floats (NaN for NA; ints where every field is an integer and none is
    NA), any other column the strings as written with NaN for NA. A short
    row is padded with NA. Names as pandas makes them: an empty one is
    ``Unnamed: j``, the second ``a`` is ``a.1``."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = rows[0], rows[1:]
    if any(len(r) > len(header) for r in body):
        raise ValueError(f"{path}: a row has more fields than the header")
    names: List[str] = []
    for j, name in enumerate(header):
        name = name or f"Unnamed: {j}"
        base, n = name, 0
        while name in names:
            n += 1
            name = f"{base}.{n}"
        names.append(name)
    table: Dict[str, list] = {}
    for j, name in enumerate(names):
        raw = [r[j] if j < len(r) else "" for r in body]
        nums = [_number(s) for s in raw]
        if all(x is not None for x in nums):
            ints = all(not math.isnan(x) and x.is_integer()
                       and "." not in s and "e" not in s.lower()
                       for s, x in zip(raw, nums))
            table[name] = [int(x) for x in nums] if ints else nums
        else:
            table[name] = [math.nan if s in _NA_STRINGS else s for s in raw]
    return names, table


def _is_na(x) -> bool:
    return isinstance(x, float) and math.isnan(x)


# ---------------------------------------------------------------------------
# EEG labels
# ---------------------------------------------------------------------------

def load_eeg_labels(label_dir: str | Path, binary: bool = True) -> Dict[int, int]:
    """medical_score.csv → {subject_id: label}; 'Postoperative evaluation'
    ≤ 2 → 0 (good outcome) else 1."""
    csv_path = os.path.join(str(label_dir), "medical_score.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(f"Label file not found: {csv_path}")
    _, table = _read_csv_table(csv_path)
    scores = table["Postoperative evaluation"]
    subjects = table["Subject"]
    if not all(isinstance(s, (int, float)) for s in scores):
        raise TypeError(f"{csv_path}: 'Postoperative evaluation' is not "
                        f"numeric")
    numeric = all(isinstance(s, (int, float)) for s in subjects)
    labels: Dict[int, int] = {}
    for subj, score in zip(subjects, scores):
        if _is_na(score):   # dropna(subset=["Postoperative evaluation"])
            continue
        # a numeric Subject column, or 'subNN' strings
        subj = int(subj) if numeric else int(str(subj).replace("sub", ""))
        labels[subj] = (0 if score <= 2 else 1) if binary else score
    return labels


def _first_mat_array(path: str) -> Optional[np.ndarray]:
    """First non-metadata variable of a classic .mat file, float32.

    Native fast path first (native/fastio.cpp `fio_read_mat`: mmap + zlib,
    no per-file Python overhead — the EEG ingest is thousands of small
    files, reference ``eeg_data_utils.py:46-119``); scipy covers whatever
    the native parser declines (sparse/struct/complex, …)."""
    from multimodal_eeg_fmri_tpu_torch.data import native_io

    native = native_io.read_mat_f32(path)
    if native is not None:
        return native

    from scipy.io import loadmat

    mat = loadmat(path)
    for k, v in mat.items():
        if not k.startswith("_"):
            return np.nan_to_num(
                np.asarray(v, dtype=np.float32), nan=0.0)
    return None


_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _is_hdf5(path: str) -> bool:
    """Whether ``path`` is an HDF5 file (MATLAB v7.3): the signature at
    offset 0, 512, 1024 or 2048 (v7.3 files keep a 512-byte header)."""
    try:
        with open(path, "rb") as f:
            for offset in (0, 512, 1024, 2048):
                f.seek(offset)
                if f.read(8) == _HDF5_SIGNATURE:
                    return True
    except OSError:
        pass
    return False


# ---------------------------------------------------------------------------
# EEG feature files
# ---------------------------------------------------------------------------

def _read_mat_many(paths: Sequence[str]) -> list:
    """Parse many classic .mat files: one native thread-pool batch
    (native/fastio.cpp ``fio_read_mat_batch``), then a per-file
    fallback for whatever the native parser declined. Order matches
    ``paths``; unreadable files yield None (with a warning, matching the
    reference's robustness policy)."""
    from multimodal_eeg_fmri_tpu_torch.data import native_io

    results = native_io.read_mat_batch(paths) if paths else []
    out = []
    for p, arr in zip(paths, results):
        if arr is None:
            try:
                arr = _first_mat_array(p)
            except Exception as e:  # noqa: BLE001 — match reference robustness
                logger.warning("Error loading %s: %s", p, e)
                arr = None
        out.append(arr)
    return out


def load_eeg_conn_features(
    conn_dir: str | Path,
    subject_list: Sequence[int],
    band_list: Mapping[str, str],
    cond_list: Sequence[str],
) -> Dict[Tuple, np.ndarray]:
    """``conn_{BandName}_{cond}_subNN.mat`` (falls back to the lowercase
    band key) → {(subject, band_key, cond, 0): flat float32 vector}.

    Two-phase ingest: gather every path first, parse them all on the
    native thread pool, then assign in gather order (so a later file for
    the same key still wins, as in the reference's sequential loop)."""
    conn_dir = Path(conn_dir)
    entries: list = []
    for subj in subject_list:
        s = f"{subj:02d}"
        for band_key, band_name in band_list.items():
            for cond in cond_list:
                files = sorted(glob.glob(
                    str(conn_dir / f"conn_{band_name}_{cond}_sub{s}.mat")))
                if not files:
                    files = sorted(glob.glob(
                        str(conn_dir / f"conn_{band_key}_{cond}_sub{s}.mat")))
                entries.extend(((subj, band_key, cond, 0), f) for f in files)
    arrays = _read_mat_many([p for _, p in entries])
    out: Dict[Tuple, np.ndarray] = {}
    for (key, _), data in zip(entries, arrays):
        if data is not None:
            out[key] = data.flatten()
    logger.info("Loaded %d EEG connectivity samples", len(out))
    return out


def load_eeg_pw_features(
    pw_dir: str | Path,
    subject_list: Sequence[int],
    band_list: Sequence[str],
    freq_list: Sequence[str],
) -> Dict[Tuple, np.ndarray]:
    """``powspctrm_{band}_{freq}_subNN.mat`` → flat float32 vectors.
    Same two-phase native batch ingest as ``load_eeg_conn_features``."""
    pw_dir = Path(pw_dir)
    entries: list = []
    for subj in subject_list:
        s = f"{subj:02d}"
        for band in band_list:
            for freq in freq_list:
                entries.extend(
                    ((subj, band, freq, 0), f)
                    for f in sorted(glob.glob(
                        str(pw_dir / f"powspctrm_{band}_{freq}_sub{s}.mat"))))
    arrays = _read_mat_many([p for _, p in entries])
    out: Dict[Tuple, np.ndarray] = {}
    for (key, _), data in zip(entries, arrays):
        if data is not None:
            out[key] = data.flatten()
    logger.info("Loaded %d EEG power samples", len(out))
    return out


def _erp_from_hdf5(path: str) -> Optional[np.ndarray]:
    """The ERP of a MATLAB v7.3 file: 'erp_struct'/'erp' (else the first)
    group's 'avg' (C, T), or its 'trial' (trials, C, T) averaged, else its
    first array of two or more dims. Raises where h5py is not installed or
    the file is not HDF5."""
    import h5py

    with h5py.File(path, "r") as hf:
        if "erp_struct" in hf:
            g = hf["erp_struct"]
        elif "erp" in hf:
            g = hf["erp"]
        else:
            g = hf[list(hf.keys())[0]]
        if "avg" in g:
            return np.asarray(g["avg"], np.float32)
        if "trial" in g:
            data = np.asarray(g["trial"], np.float32)
            return data.mean(axis=0) if data.ndim == 3 else data
        for dk in g.keys():
            cand = g[dk]
            if getattr(cand, "ndim", 0) >= 2:
                return np.asarray(cand, np.float32)
    return None


def load_eeg_erp_features(
    erp_dir: str | Path,
    subject_list: Sequence[int],
    band_list: Sequence[str],
    freq_list: Sequence[str],
) -> Dict[Tuple, np.ndarray]:
    """``ERP_subNN_{band}_{freq}*.mat`` — MATLAB v7.3 (HDF5) files with an
    'erp_struct'/'erp' group holding 'avg' (C, T) or 'trial' (trials, C, T,
    averaged); classic-format fallback (native, else scipy). Without h5py a
    v7.3 file raises an ``ImportError`` that names h5py."""
    erp_dir = Path(erp_dir)
    out: Dict[Tuple, np.ndarray] = {}
    for subj in subject_list:
        s = f"{subj:02d}"
        for band in band_list:
            for freq in freq_list:
                for f in sorted(glob.glob(
                        str(erp_dir / f"ERP_sub{s}_{band}_{freq}*.mat"))):
                    data = None
                    try:
                        data = _erp_from_hdf5(f)
                    except Exception as e:  # noqa: BLE001
                        if isinstance(e, ImportError) and _is_hdf5(f):
                            raise ImportError(
                                f"{f} is a MATLAB v7.3 (HDF5) file; reading "
                                f"it needs h5py, which is not installed"
                            ) from e
                        try:
                            data = _first_mat_array(f)
                        except Exception:  # noqa: BLE001
                            logger.warning("Error loading ERP %s: %s", f, e)
                    if data is not None:
                        out[(subj, band, freq, 0)] = np.nan_to_num(
                            data, nan=0.0)
    logger.info("Loaded %d EEG ERP samples", len(out))
    return out


# ---------------------------------------------------------------------------
# fMRI CSVs
# ---------------------------------------------------------------------------

def _read_feature_csv(fp: Path) -> Optional[np.ndarray]:
    """Numeric feature CSV → float32 (rows, cols), NaN→0.

    Fast path: the native mmap parser (data/native_io.py) when the file has
    no 'Subject' id column to drop; the ``csv`` module otherwise (column
    names need the header). A column that is not numeric raises."""
    try:
        with open(fp, "r") as f:
            header = f.readline()
    except OSError:
        return None
    if "Subject" not in header:
        from multimodal_eeg_fmri_tpu_torch.data import native_io

        arr = native_io.read_csv_f32(fp)
        if arr is not None:
            return arr
    names, table = _read_csv_table(fp)
    names = [n for n in names if n != "Subject"]
    if bad := [n for n in names
               if not all(isinstance(x, (int, float)) for x in table[n])]:
        raise ValueError(f"{fp}: columns {bad} are not numeric")
    n_rows = len(table[names[0]]) if names else 0
    values = np.array([table[n] for n in names], np.float64).reshape(
        len(names), n_rows).T
    return np.nan_to_num(values.astype(np.float32), nan=0.0)


def load_fmri_activation_features(
    data_dir: str | Path,
    subject_list: Sequence[int],
    activation_types: Sequence[str],
    agg_method: str = "both",
) -> Dict[int, np.ndarray]:
    """``sub-N/subject_N_activation_{type}.csv`` → per-subject concatenated
    mean/std/both aggregates over rows (NaN→0)."""
    data_dir = Path(data_dir)
    out: Dict[int, np.ndarray] = {}
    missing = []
    for subj in subject_list:
        feats = []
        for act in activation_types:
            fp = data_dir / f"sub-{subj}" / f"subject_{subj}_activation_{act}.csv"
            if not fp.exists():
                missing.append(str(fp))
                continue
            try:
                arr = _read_feature_csv(fp)
                if arr is None:
                    continue
                if agg_method == "mean":
                    feats.append(arr.mean(0))
                elif agg_method == "std":
                    feats.append(arr.std(0))
                elif agg_method == "both":
                    feats.append(np.concatenate([arr.mean(0), arr.std(0)]))
                else:
                    raise ValueError(f"Unknown agg method {agg_method!r}")
            except Exception as e:  # noqa: BLE001
                logger.warning("Error loading %s: %s", fp, e)
        if feats:
            out[subj] = np.concatenate(feats)
    logger.info("fMRI activation: %d/%d subjects (%d missing files)",
                len(out), len(subject_list), len(missing))
    return out


def load_fmri_connectivity_features(
    data_dir: str | Path,
    subject_list: Sequence[int],
    connectivity_types: Sequence[str],
) -> Dict[int, np.ndarray]:
    """``sub-N/subject_N_fdr_PPI_Connectivity_{type}.csv`` → flattened."""
    data_dir = Path(data_dir)
    out: Dict[int, np.ndarray] = {}
    for subj in subject_list:
        feats = []
        for conn in connectivity_types:
            fp = (data_dir / f"sub-{subj}"
                  / f"subject_{subj}_fdr_PPI_Connectivity_{conn}.csv")
            if not fp.exists():
                continue
            try:
                arr = _read_feature_csv(fp)
                if arr is not None:
                    feats.append(arr.flatten())
            except Exception as e:  # noqa: BLE001
                logger.warning("Error loading %s: %s", fp, e)
        if feats:
            out[subj] = np.concatenate(feats)
    logger.info("fMRI connectivity: %d/%d subjects", len(out),
                len(subject_list))
    return out


_SUBJ_COLS = ["Subject", "subject", "SubjectID", "subject_id", "ID", "id"]
_LABEL_COLS = ["Label", "label", "Outcome", "outcome", "Class", "class",
               "Group", "group"]
_REG_COLS = ["Score", "score", "Value", "value", "Continuous", "continuous"]


def load_fmri_labels(
    label_path: str | Path,
    subject_list: Sequence[int],
    binary: bool = True,
    allow_dummy: bool = True,
    seed: int = 0,
) -> Tuple[Dict[int, int], Optional[Dict[int, float]]]:
    """Label-file discovery over candidate names/columns; random dummy
    labels as a last resort (reference ``run_fmri_v11.py:158-212``) so the
    pipeline still exercises end-to-end."""
    label_path = Path(label_path)
    candidates = [label_path / "labels.csv", label_path / "outcomes.csv",
                  label_path / "subjects_labels.csv",
                  label_path.parent / "labels.csv"]
    label_file = next((c for c in candidates if c.exists()), None)
    if label_file is None:
        if not allow_dummy:
            raise FileNotFoundError(f"no label file under {label_path}")
        logger.warning("No label file found — using dummy labels")
        rng = np.random.default_rng(seed)
        cls = {s: int(rng.integers(0, 2)) for s in subject_list}
        reg = {s: float(rng.standard_normal()) for s in subject_list}
        return cls, reg

    names, table = _read_csv_table(label_file)
    subj_col = next((c for c in _SUBJ_COLS if c in names), None)
    label_col = next((c for c in _LABEL_COLS if c in names), None)
    reg_col = next((c for c in _REG_COLS if c in names), None)
    if not subj_col or not label_col:
        raise ValueError(
            f"Could not identify subject/label columns in {label_file}")
    cls: Dict[int, int] = {}
    reg: Dict[int, float] = {}
    for i, subj in enumerate(table[subj_col]):
        subj = int(subj)
        if subj not in subject_list:
            continue
        label = table[label_col][i]
        if binary:
            if isinstance(label, str):
                label = 1 if label.lower() in ("good", "positive", "yes",
                                               "1") else 0
            else:
                label = int(label)
        cls[subj] = label
        if reg_col is not None:
            reg[subj] = float(table[reg_col][i])
    return cls, (reg or None)
