"""Class-based trainer, the ``FlexibleTrainer`` API (PyTorch). Counterpart
of ``multimodal_eeg_fmri_tpu/train/trainer.py``.

``train_one_epoch`` / ``evaluate`` / ``update_best`` / ``fit`` /
``save_checkpoint`` / ``load_checkpoint`` over the whole-run core of
``train/fit.py``: each epoch is a one-epoch ``fit`` that resumes the
previous one's carry, with the core's own early stop disarmed, while best-
state tracking, early stopping and the LR schedule (plateau or warmup-cosine)
run on the host.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.data.arrays import validate_dataset
from multimodal_eeg_fmri_tpu_torch.ops.schedules import (
    EarlyStopping,
    ReduceLROnPlateau,
)
from multimodal_eeg_fmri_tpu_torch.train.evaluate import evaluate_dataset
from multimodal_eeg_fmri_tpu_torch.train.fit import (
    _cosine_scale,
    initial_carry,
    make_fit_fn,
)


def _host(data) -> dict:
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in data.items()}


class Trainer:
    """Stateful epoch-at-a-time trainer of ``model`` (trained in place)
    over the whole-run fit core. ``generator`` (a ``torch.Generator`` on the
    model's device, or an int seed; default ``cfg.seed``) drives shuffling
    and augmentation, the JAX trainer's ``rng``."""

    def __init__(self, model: nn.Module, cfg: Optional[TrainConfig] = None,
                 task: str = "classification", augment=None,
                 generator: Union[torch.Generator, int, None] = None):
        self.model = model
        self.cfg = cfg or TrainConfig()
        self.task = task
        dev = next(model.parameters()).device
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                self.cfg.seed if generator is None else generator)
        self.generator = generator
        # selection, early stopping and the schedule live on the host here:
        # the core's own early stop is disarmed so that it cannot freeze the
        # updates underneath the host loop
        self._one_epoch_cfg = dataclasses.replace(
            self.cfg, schedule="constant", selection="train_loss",
            patience=10**9)
        self._fit1 = make_fit_fn(model, self._one_epoch_cfg, num_epochs=1,
                                 task=task, eval_names=(), augment=augment)
        self._carry = None
        self.epoch = 0
        self.history: Dict[str, list] = {}
        self.best_state = None
        self._plateau = ReduceLROnPlateau(
            factor=self.cfg.plateau_factor,
            patience=self.cfg.plateau_patience,
            min_lr_scale=self.cfg.min_lr / self.cfg.learning_rate)
        self._early = EarlyStopping(patience=self.cfg.patience,
                                    min_delta=self.cfg.min_delta)

    @property
    def best_metric(self) -> float:
        s = self._early.best_score
        return -np.inf if s is None else s

    @property
    def stopped(self) -> bool:
        return self._early.should_stop

    @property
    def _ema(self) -> bool:
        return (self.cfg.ema_decay or 0) > 0

    # -- state access -------------------------------------------------------
    @property
    def params(self):
        return None if self._carry is None else self._carry.params

    @property
    def batch_stats(self):
        return None if self._carry is None else self._carry.batch_stats

    @property
    def eval_params(self):
        """The params of evaluation and selection: the EMA when
        ``cfg.ema_decay > 0``, else the raw training params."""
        if self._carry is None:
            return None
        return self._carry.ema_params if self._ema else self._carry.params

    def _host_lr_scale(self) -> float:
        """The LR multiplier of the next epoch, computed on the host as the
        fit core computes it for each ``TrainConfig.schedule``."""
        if self.cfg.schedule == "plateau":
            return float(self._plateau.scale)
        if self.cfg.schedule == "warmup_cosine":
            return float(_cosine_scale(self.cfg, self.epoch))
        if self.cfg.schedule == "constant":
            return 1.0
        raise ValueError(
            f"Trainer does not support schedule={self.cfg.schedule!r}")

    # -- API ---------------------------------------------------------------
    def train_one_epoch(self, train_data, class_weights=None) -> float:
        """Run one epoch; returns the mean train loss."""
        if self._carry is None:
            validate_dataset(
                _host(train_data),
                require_label=self.task == "classification",
                batch_size=self.cfg.batch_size, name="train_data")
        scale = self._host_lr_scale()
        if self._carry is None and scale != 1.0:
            # the first epoch already runs at the scheduled scale
            self._carry = initial_carry(self.model, self._ema)
        if self._carry is not None:
            self._carry = self._carry._replace(
                lr_scale=torch.tensor(scale, dtype=torch.float32))
        res = self._fit1(self.generator, train_data, {}, class_weights, None,
                         self._carry)
        self._carry = res.carry
        loss = float(res.history["train_loss"][0])
        self.history.setdefault("train_loss", []).append(loss)
        self.epoch += 1
        if self.cfg.schedule == "plateau":
            self._plateau.step(loss)
        return loss

    def evaluate(self, data) -> Dict[str, float]:
        """Whole-dataset evaluation with the current (EMA) params."""
        metrics, _ = evaluate_dataset(self.model, self.eval_params,
                                      self.batch_stats, data, task=self.task)
        out = {k: float(v) for k, v in metrics.items()}
        for k, v in out.items():
            self.history.setdefault(k, []).append(v)
        return out

    def update_best(self, metric: float) -> bool:
        """Best-state tracking and early stopping (``EarlyStopping``: an
        improvement by more than ``cfg.min_delta`` resets the count of bad
        epochs, ``cfg.patience`` of them stop)."""
        self._early(metric)
        improved = self._early.counter == 0
        if improved:
            self.best_state = (self.eval_params, self.batch_stats)
        return improved

    def fit(self, train_data, val_data=None, class_weights=None,
            metric: str = "f1") -> Dict[str, list]:
        """Epoch loop with early stopping; selection on ``val_data``'s
        ``metric``, else on the train loss."""
        for _ in range(self.cfg.num_epochs):
            if self.stopped:
                break
            loss = self.train_one_epoch(train_data, class_weights)
            if val_data is not None:
                self.update_best(self.evaluate(val_data)[metric])
            else:
                self.update_best(-loss)
        return self.history

    # -- persistence --------------------------------------------------------
    def save_checkpoint(self, path: Union[str, Path],
                        metrics: Optional[Dict[str, float]] = None) -> Path:
        """Full-state checkpoint: the best params in the main slot (what
        downstream consumers load), and the live training state (current
        params and statistics, AdamW state, both generators, the EMA) and
        the host controllers (epoch, best metric, early stop, plateau), so
        that a resume continues bit-exactly."""
        c = self._carry if self._carry is not None else initial_carry(
            self.model, self._ema)
        params, bs = (self.best_state if self.best_state is not None
                      else (c.params, c.batch_stats))
        extra = {"cur_params": c.params, "cur_batch_stats": c.batch_stats,
                 "rng": c.rng, "torch_rng": c.torch_rng}
        if self._ema:
            extra["ema_params"] = c.ema_params
        trainer_state = {
            "epoch": self.epoch,
            "best_metric": float(self.best_metric),
            "bad_epochs": self._early.counter,
            "stopped": bool(self.stopped),
            "plateau": {"best": self._plateau.best,
                        "bad_epochs": self._plateau.bad_epochs,
                        "scale": self._plateau.scale},
            "history": {k: [float(v) for v in vs]
                        for k, vs in self.history.items()},
        }
        return save_checkpoint(
            path, params, batch_stats=bs, opt_state=c.opt_state,
            step=self.epoch,
            metrics=metrics or {"best_metric": float(self.best_metric)},
            metadata={"trainer_state": trainer_state}, extra=extra)

    def load_checkpoint(self, path: Union[str, Path], train_data=None) -> None:
        """Restore the whole trainer state. The module gives the state its
        structure, so this works before any training; ``train_data``, which
        the JAX trainer needs for that, is accepted and not used. A
        checkpoint written without an EMA seeds it from the restored params;
        one written with it loads into a trainer without an EMA by dropping
        it."""
        dev = next(self.model.parameters()).device
        restored = load_checkpoint(path, map_location=dev)
        extra = restored.get("extra") or {}
        c = self._carry if self._carry is not None else initial_carry(
            self.model)
        cur_params = extra.get("cur_params", restored["params"])
        c = c._replace(
            params=cur_params,
            batch_stats=extra.get("cur_batch_stats",
                                  restored.get("batch_stats", {})),
            opt_state=restored.get("opt_state", c.opt_state),
            ema_params=(extra.get("ema_params") or cur_params) if self._ema
            else None)
        if extra.get("rng") is not None:
            c = c._replace(rng=extra["rng"].cpu())
            self.generator.set_state(c.rng)
        if extra.get("torch_rng") is not None:
            c = c._replace(torch_rng=extra["torch_rng"].cpu())
        self._carry = c
        self.best_state = (restored["params"], restored.get("batch_stats", {}))

        ts = (restored.get("metadata") or {}).get("trainer_state")
        if ts:
            self.epoch = int(ts["epoch"])
            best = float(ts["best_metric"])
            self._early.best_score = None if best == -np.inf else best
            self._early.counter = int(ts["bad_epochs"])
            self._early.should_stop = bool(ts["stopped"])
            p = ts.get("plateau") or {}
            self._plateau.best = p.get("best")
            self._plateau.bad_epochs = int(p.get("bad_epochs", 0))
            self._plateau.scale = float(p.get("scale", 1.0))
            self.history = {k: list(v)
                            for k, v in (ts.get("history") or {}).items()}
