"""Logging and a metrics sink (PyTorch port). Counterpart of
``multimodal_eeg_fmri_tpu/core/logging.py``, copied.

Replaces the reference's ``setup_logging`` (``EEG_CODE/config.py:83-94``:
file + console handlers) and its scattered per-epoch print/log lines with one
logger factory and a metrics logger that accumulates scalar series and can
export them as CSV/JSONL — the reference exports fold/epoch metrics as ad-hoc
CSVs (``fMRI_CODE/run_fmri_v11.py:690-709``).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional


def get_logger(
    name: str = "multimodal_eeg_fmri_tpu_torch",
    log_dir: Optional[str] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Idempotent logger factory: console + optional per-run file handler
    (reference ``EEG_CODE/config.py:83-94`` ``setup_logging``)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / f"{name}_{int(time.time())}.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsLogger:
    """Accumulates scalar metric series keyed by (tag, step).

    Device values are accepted lazily (tensors on the card are converted on
    flush) so logging never forces a sync inside the hot loop.
    """

    def __init__(self):
        self._series: Dict[str, List[tuple]] = defaultdict(list)
        self._t0 = time.monotonic()
        self._wall0 = time.time()  # wall-clock base for tensorboard export

    def log(self, step: int, **metrics: Any) -> None:
        t = time.monotonic() - self._t0
        for k, v in metrics.items():
            self._series[k].append((step, t, v))

    def series(self, tag: str) -> List[tuple]:
        return [(s, float(v)) for s, _, v in self._series.get(tag, [])]

    def latest(self, tag: str, default: float = float("nan")) -> float:
        s = self._series.get(tag)
        return float(s[-1][2]) if s else default

    def to_jsonl(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for tag, rows in self._series.items():
                for step, t, v in rows:
                    f.write(json.dumps({"tag": tag, "step": step, "time": t,
                                        "value": float(v)}) + "\n")

    def to_csv(self, path: str | Path) -> None:
        import csv

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["tag", "step", "time_s", "value"])
            for tag, rows in self._series.items():
                for step, t, v in rows:
                    w.writerow([tag, step, f"{t:.4f}", float(v)])

    def to_tensorboard(self, log_dir: str | Path) -> Optional[Path]:
        """Export every series as TensorBoard scalar events under
        ``log_dir`` (one events file; view with ``tensorboard --logdir``).

        The reference has no experiment tracking beyond print/log lines;
        this writes the standard format instead of inventing one. Imports
        tensorboard lazily and returns None (with a warning) when it is
        unavailable — the JSONL/CSV exports above carry the same data.
        """
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )
        except Exception as e:  # pragma: no cover - env without tensorboard
            logging.getLogger(__name__).warning(
                "tensorboard unavailable (%s); use to_jsonl/to_csv", e)
            return None
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        writer = EventFileWriter(str(log_dir))
        try:
            for tag, rows in self._series.items():
                for step, t, v in rows:
                    ev = Event(
                        wall_time=self._wall0 + t, step=int(step),
                        summary=Summary(value=[Summary.Value(
                            tag=tag, simple_value=float(v))]))
                    writer.add_event(ev)
        finally:
            writer.close()
        return log_dir
