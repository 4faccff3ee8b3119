"""Checkpoints (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/core/checkpoint.py``, with the same functions.

A checkpoint is a directory: ``state.pt``, written by ``torch.save``, holds
the tensors (params, batch_stats, optimizer state, step, extra) as nested
dicts, and ``metadata.json`` the step, the metrics and any metadata, in the
JAX package's layout. ``load_checkpoint`` reads tensors only
(``weights_only=True``). The frozen-encoder artifact is params + batch_stats
+ the model's name and config, what a bridge stage loads without knowing
anything about the optimizer; ``find_best_checkpoint`` picks the fold
checkpoint with the highest stored metric.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str | Path, params: Any, batch_stats: Any = None,
                    opt_state: Any = None, step: int = 0,
                    metrics: Optional[Dict[str, float]] = None,
                    metadata: Optional[Dict[str, Any]] = None,
                    extra: Any = None) -> Path:
    """Write a train-state checkpoint (params, statistics, optimizer state,
    step, metrics) into the directory ``path``, replacing one that is
    there. ``extra`` is any further nest of tensors and Python scalars
    stored beside them (the trainer's live state for an exact resume)."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tree = {"params": params, "step": int(step)}
    for key, value in (("batch_stats", batch_stats), ("opt_state", opt_state),
                       ("extra", extra)):
        if value is not None:
            tree[key] = value
    torch.save(tree, path / STATE_FILE)
    meta = {"step": int(step), "metrics": metrics or {}, **(metadata or {})}
    (path / "metadata.json").write_text(json.dumps(meta, indent=2))
    return path


def load_checkpoint(path: str | Path,
                    map_location: Any = "cpu") -> Dict[str, Any]:
    """The checkpoint's dict (and its ``metadata`` if present), tensors on
    ``map_location``. torch keeps structure and dtypes, so no template is
    needed, unlike orbax's restore."""
    path = Path(path).absolute()
    tree = torch.load(path / STATE_FILE, map_location=map_location,
                      weights_only=True)
    meta_file = path / "metadata.json"
    if meta_file.exists():
        tree["metadata"] = json.loads(meta_file.read_text())
    return tree


def export_frozen_encoder(path: str | Path, model_name: str, params: Any,
                          batch_stats: Any = None,
                          config: Optional[Dict[str, Any]] = None,
                          metrics: Optional[Dict[str, float]] = None) -> Path:
    """Stage-1 → stage-2 artifact: enough to rebuild the frozen encoder
    (params + batch_stats + model identity/config), nothing else."""
    return save_checkpoint(
        path, params, batch_stats=batch_stats, metrics=metrics,
        metadata={"model_name": model_name, "config": config or {},
                  "artifact": "frozen_encoder"})


def find_best_checkpoint(checkpoint_dir: str | Path,
                         pattern: str = "best_trimodal_fold*",
                         metric: str = "f1") -> Optional[Path]:
    """The checkpoint under ``checkpoint_dir`` matching ``pattern`` with the
    highest stored ``metric``; without metrics, the highest fold number."""
    candidates = sorted(Path(checkpoint_dir).glob(pattern))
    if not candidates:
        return None
    best, best_score = None, -np.inf
    for c in candidates:
        meta = c / "metadata.json"
        score = -np.inf
        if meta.exists():
            try:
                score = json.loads(meta.read_text()).get("metrics", {}).get(
                    metric, -np.inf)
            except (json.JSONDecodeError, OSError):
                pass
        if best is None or score > best_score:
            best, best_score = c, max(score, best_score)
    if best_score == -np.inf:
        def fold_num(p):
            m = re.search(r"(\d+)$", p.name)
            return int(m.group(1)) if m else -1
        best = max(candidates, key=fold_num)
    return best
