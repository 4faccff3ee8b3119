"""Result exports: detailed/summary CSVs, XAI NPZ bundles, text reports.
Counterpart of ``multimodal_eeg_fmri_tpu/report/export.py``: host code on
numpy. The JAX package writes its CSVs through pandas; the card's machine
has no pandas, so the port's CSV writers use the ``csv`` module and write
the bytes that ``pandas.DataFrame(rows).to_csv(index=False)`` writes
(``_write_csv``). ``results_dataframe`` and ``summary_dataframe`` still
return pandas frames and import pandas when called.

Reference: ``create_results_dataframe``/``create_summary_dataframe`` + CSV
writes (``run_fmri_v11.py:510-548,690-709``), fold/fusion-weight CSVs
(``CrossModal_EEG_scr.ipynb §30``), ``bridge_xai_arrays_*.npz``
(``_test_bridge.py:1314-1366``), ``create_analysis_report``
(``eeg_xai_analysis.py:874-925``).
"""

from __future__ import annotations

import csv
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np


def _results_rows(results: Mapping[str, Any]) -> list:
    rows = []
    for model, res in results.items():
        for metric, values in res.fold_metrics.items():
            for fold, v in enumerate(values):
                rows.append({"model": model, "fold": fold,
                             "metric": metric, "value": float(v)})
    return rows


def _summary_rows(results: Mapping[str, Any]) -> list:
    rows = []
    for model, res in results.items():
        row = {"model": model}
        for metric, (mean, std) in res.summary.items():
            row[f"{metric}_mean"] = mean
            row[f"{metric}_std"] = std
        rows.append(row)
    return rows


def results_dataframe(results: Mapping[str, Any]):
    """Per-fold long-format dataframe over CVResults
    {model: CVResult} → columns model/fold/metric/value."""
    import pandas as pd

    return pd.DataFrame(_results_rows(results))


def summary_dataframe(results: Mapping[str, Any]):
    """mean ± std summary table (reference summary CSV)."""
    import pandas as pd

    return pd.DataFrame(_summary_rows(results))


def _column_text(values: list) -> list:
    """A column's fields as pandas writes them: a column of bools or of
    ints as they are; a column of numbers with a float or a missing value
    as float64 (``repr``, missing ''); any other column with ``str``,
    missing ''."""
    def is_int(v):
        return isinstance(v, (int, np.integer)) and not isinstance(
            v, (bool, np.bool_))

    present = [v for v in values if v is not None]
    if values and len(present) == len(values) and all(
            isinstance(v, (bool, np.bool_)) for v in values):
        return [str(bool(v)) for v in values]
    if values and len(present) == len(values) and all(map(is_int, values)):
        return [str(int(v)) for v in values]
    if all(is_int(v) or isinstance(v, (float, np.floating))
           for v in present):
        return ["" if v is None or math.isnan(v) else repr(float(v))
                for v in values]
    return ["" if v is None else str(v) for v in values]


def _write_csv(path: Path, rows: Sequence[Mapping[str, Any]]) -> None:
    """``rows`` as ``pandas.DataFrame(rows).to_csv(path, index=False)``
    writes them: columns in first-seen order, minimal quoting, '\n'."""
    names = list(dict.fromkeys(k for r in rows for k in r))
    columns = [_column_text([r.get(k) for r in rows]) for k in names]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*columns))


def export_cv_results(
    results: Mapping[str, Any],
    output_dir: str | Path,
    prefix: str = "results",
    timestamp: bool = True,
) -> Dict[str, Path]:
    """Write detailed + summary CSVs (and per-model history CSVs)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"_{int(time.time())}" if timestamp else ""
    paths = {}
    detailed = out / f"{prefix}_detailed{tag}.csv"
    _write_csv(detailed, _results_rows(results))
    paths["detailed"] = detailed
    summary = out / f"{prefix}_summary{tag}.csv"
    _write_csv(summary, _summary_rows(results))
    paths["summary"] = summary
    return paths


def export_xai_arrays(
    xai: Mapping[str, np.ndarray],
    output_dir: str | Path,
    prefix: str = "xai_arrays",
    timestamp: bool = True,
) -> Path:
    """NPZ bundle of attribution arrays (reference bridge_xai_arrays npz)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"_{int(time.time())}" if timestamp else ""
    path = out / f"{prefix}{tag}.npz"
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in xai.items()})
    return path


def export_per_subject_records(
    records: Sequence[dict], output_dir: str | Path,
    prefix: str = "per_subject", timestamp: bool = True,
) -> Path:
    """Per-subject prediction/weight records → CSV."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"_{int(time.time())}" if timestamp else ""
    rows = []
    for r in records:
        row = {k: v for k, v in r.items()
               if not isinstance(v, np.ndarray)}
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                for i, x in enumerate(np.ravel(v)):
                    row[f"{k}_{i}"] = float(x)
        rows.append(row)
    path = out / f"{prefix}{tag}.csv"
    _write_csv(path, rows)
    return path


def write_analysis_report(
    path: str | Path,
    channel_importance,
    metrics: Optional[Mapping[str, float]] = None,
    extra: Optional[Mapping[str, Any]] = None,
) -> Path:
    """Human-readable XAI text report (reference ``create_analysis_report``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["=" * 60, "XAI ANALYSIS REPORT", "=" * 60, ""]
    if metrics:
        lines.append("Model metrics:")
        for k, v in metrics.items():
            lines.append(f"  {k}: {v:.4f}")
        lines.append("")
    lines.append("Top channels by importance:")
    for name, v in channel_importance.top_k(10):
        lines.append(f"  {name}: {v:.4f}")
    lines.append("")
    lines.append("Region importance:")
    for region, v in sorted(channel_importance.region_values.items(),
                            key=lambda kv: -kv[1]):
        lines.append(f"  {region}: {v:.4f}")
    if extra:
        lines.append("")
        for k, v in extra.items():
            lines.append(f"{k}: {json.dumps(v, default=str)}")
    path.write_text("\n".join(lines) + "\n")
    return path
