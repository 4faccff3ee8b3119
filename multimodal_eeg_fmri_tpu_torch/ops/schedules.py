"""Learning-rate schedules (host side). Counterpart of
``multimodal_eeg_fmri_tpu/ops/schedules.py``.

``warmup_cosine_schedule`` returns a plain function of the step with the
values of ``optax.warmup_cosine_decay_schedule`` for the same arguments.
``ReduceLROnPlateau`` and ``EarlyStopping`` are the host-side controllers of
an epoch loop (``train/trainer.py``); ``make_fit_fn`` runs the same policies
on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int,
                           total_epochs: int, steps_per_epoch: int = 1,
                           min_lr: float = 1e-6) -> Callable[[int], float]:
    """Linear warmup from base_lr/warmup_steps to ``base_lr`` over
    ``warmup_epochs``, then cosine decay to ``min_lr`` over the remainder."""
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)
    total_steps = max(warmup_steps + 1, total_epochs * steps_per_epoch)
    init_value = base_lr / warmup_steps
    decay_steps = total_steps - warmup_steps
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - base_lr) * frac + base_lr
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass
class ReduceLROnPlateau:
    """Plateau controller as torch's ReduceLROnPlateau (mode 'min' on the
    train loss by default); ``step(metric)`` returns the LR multiplier."""

    factor: float = 0.5
    patience: int = 5
    min_lr_scale: float = 1e-3
    threshold: float = 1e-4
    mode: str = "min"

    def __post_init__(self):
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "min" and metric < self.best - self.threshold)
            or (self.mode == "max" and metric > self.best + self.threshold))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr_scale)
                self.bad_epochs = 0
        return self.scale


@dataclass
class EarlyStopping:
    """Early-stopping controller for host-driven loops; ``__call__(score)``
    returns whether to stop."""

    patience: int = 10
    min_delta: float = 1e-3
    mode: str = "max"

    def __post_init__(self):
        self.counter = 0
        self.best_score = None
        self.should_stop = False

    def __call__(self, score: float) -> bool:
        if self.best_score is None:
            self.best_score = score
            return False
        improved = (score > self.best_score + self.min_delta
                    if self.mode == "max"
                    else score < self.best_score - self.min_delta)
        if improved:
            self.best_score = score
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
