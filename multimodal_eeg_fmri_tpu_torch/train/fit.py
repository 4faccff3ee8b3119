"""Whole-run training (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/train/fit.py``.

``make_fit_fn(model, cfg, ...)`` returns ``fit(generator, train_data,
eval_sets, class_weights)``, which keeps the JAX contract: a per-epoch
shuffle from an explicit generator; ``preprocess`` merged into the batch in
train and eval; the forward in train mode, the loss, the backward; clipping
by global norm as optax does; Adam (0.9, 0.999, 1e-8) with the update
−(lr·lr_scale)·(adam + wd·p) on every parameter; per-epoch metrics on each
eval set in eval mode; best-state selection; plateau or warmup-cosine LR; and
early stopping that keeps the epoch count, so that ``history`` has
``num_epochs`` entries, and freezes params, BatchNorm statistics and
optimizer state once stopped.

Where the JAX package initialises params inside ``fit``, the module passed
in here carries its weights, the torch idiom: ``fit`` trains them in place
and leaves the module in eval mode at its final weights; ``FitResult.params``
and ``.batch_stats`` hold the best epoch's. The data moves to the model's
device once and stays there; the host reads a few scalars once per epoch
(selection and the learning rate), never per step. Dropout draws from
torch's global generator, augmentation and shuffling from the one given.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.ops.losses import make_loss_fn
from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    binary_classification_metrics,
    regression_metrics,
)

# batch keys that are not model inputs
RESERVED_KEYS = ("label", "reg_label", "weight", "subject")

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue A item 2)"


def split_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in batch.items() if k not in RESERVED_KEYS}


class FitResult(NamedTuple):
    params: Dict[str, torch.Tensor]        # best params, by parameter name
    batch_stats: Dict[str, torch.Tensor]   # best buffers (BatchNorm stats)
    final_params: Dict[str, torch.Tensor]  # last-epoch params
    final_batch_stats: Dict[str, torch.Tensor]
    best_metric: torch.Tensor
    best_epoch: torch.Tensor
    history: Dict[str, torch.Tensor]       # per-epoch series, (num_epochs,)


def _cosine_scale(cfg: TrainConfig, epoch: int, device=None) -> torch.Tensor:
    """Warmup + cosine as a multiplier on the base lr (epoch 0-indexed),
    in f32 as the JAX package computes it."""
    e = torch.tensor(epoch + 1.0, dtype=torch.float32, device=device)
    warm = max(cfg.warmup_epochs, 1)
    progress = ((e - warm) / max(cfg.num_epochs - warm, 1)).clamp(0.0, 1.0)
    min_scale = cfg.min_lr / cfg.learning_rate
    cos_scale = min_scale + 0.5 * (1.0 - min_scale) * (
        1.0 + torch.cos(math.pi * progress))
    return torch.where(e <= warm, e / warm, cos_scale)


def _plateau_update(cfg: TrainConfig, best, bad, scale, metric):
    """ReduceLROnPlateau (mode=min on the train loss) on f32/int tensors."""
    improved = metric < best - 1e-4
    best = torch.where(improved, metric, best)
    bad = torch.where(improved, 0, bad + 1)
    trigger = bad > cfg.plateau_patience
    scale = torch.where(
        trigger,
        (scale * cfg.plateau_factor).clamp_min(cfg.min_lr / cfg.learning_rate),
        scale)
    bad = torch.where(trigger, 0, bad)
    return best, bad, scale


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm/‖g‖ when the global norm ‖g‖
    reaches max_norm, as optax's ``clip_by_global_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns ‖g‖; never syncs."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def _check_supported(cfg: TrainConfig):
    if cfg.grad_accum > 1:
        raise NotImplementedError(f"grad_accum={cfg.grad_accum} {_NOT_PORTED}")
    if cfg.ema_decay > 0:
        raise NotImplementedError(f"ema_decay={cfg.ema_decay} {_NOT_PORTED}")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} {_NOT_PORTED}")


class TrainStep:
    """One optimizer step of ``make_fit_fn``: augment, preprocess, the
    forward in train mode, the loss, the backward, global-norm clipping and
    AdamW. Owns the optimizer. ``step(batch)`` returns the loss, a device
    scalar, without reading it back."""

    def __init__(self, model: nn.Module, cfg: TrainConfig, *,
                 task: str = "classification",
                 loss_kwargs: Optional[dict] = None,
                 augment: Optional[Callable] = None,
                 preprocess: Optional[Callable] = None):
        _check_supported(cfg)
        self.model, self.cfg = model, cfg
        self.augment, self.preprocess = augment, preprocess
        lk = dict(loss_kwargs or {})
        if task == "regression":
            self.loss_fn = make_loss_fn("mse")
        else:
            if cfg.loss == "focal":
                lk.setdefault("alpha", cfg.focal_alpha)
                lk.setdefault("gamma", cfg.focal_gamma)
            if cfg.loss == "label_smoothing":
                lk.setdefault("smoothing", cfg.label_smoothing)
            self.loss_fn = make_loss_fn(cfg.loss, **lk)
        self.params = list(model.parameters())
        # every parameter gets a gradient, zero where none flows (a frozen
        # encoder), so that Adam and the weight decay update it as optax does
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def inputs(self, batch: Dict[str, torch.Tensor]):
        """The model inputs of a batch, with ``preprocess`` merged in."""
        if self.preprocess is not None:
            batch = {**batch, **self.preprocess(split_batch(batch))}
        return split_batch(batch)

    def loss(self, batch, class_weights=None) -> torch.Tensor:
        """The forward in train mode and the loss; updates the BatchNorm
        running statistics."""
        self.model.train()
        out = self.model(**self.inputs(batch))
        return self.loss_fn(out.logits, batch["label"], class_weights,
                            batch.get("weight"))

    def __call__(self, batch, class_weights=None,
                 generator: Optional[torch.Generator] = None,
                 lr: Optional[float] = None,
                 wd: Optional[float] = None) -> torch.Tensor:
        if self.augment is not None:
            batch = self.augment(generator, batch)
        loss = self.loss(batch, class_weights)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        if self.cfg.grad_clip and self.cfg.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.cfg.grad_clip)
        group = self.optimizer.param_groups[0]
        group["lr"] = self.cfg.learning_rate if lr is None else lr
        group["weight_decay"] = self.cfg.weight_decay if wd is None else wd
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def frozen(self, batch, class_weights=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of a step taken after early stopping: params,
        optimizer state and BatchNorm statistics stay as they are."""
        if self.augment is not None:
            batch = self.augment(generator, batch)
        buffers = [b.clone() for b in self.model.buffers()]
        loss = self.loss(batch, class_weights)
        for b, saved in zip(self.model.buffers(), buffers):
            b.copy_(saved)
        return loss


def _snapshot(model: nn.Module):
    """(params, the other state-dict tensors), cloned."""
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k not in params}
    return params, stats


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """An array or a tensor of any device, on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _to_device(data, device) -> Dict[str, torch.Tensor]:
    return {k: _as_tensor(v, device) for k, v in data.items()}


def make_fit_fn(model: nn.Module, cfg: TrainConfig, *,
                num_epochs: Optional[int] = None,
                task: str = "classification",
                eval_names: Tuple[str, ...] = ("val", "test"),
                loss_kwargs: Optional[dict] = None,
                augment: Optional[Callable] = None,
                preprocess: Optional[Callable] = None,
                param_sharding: Optional[Callable] = None
                ) -> Callable[..., FitResult]:
    """Build ``fit(generator, train_data, eval_sets, class_weights=None,
    hyper=None)`` that trains ``model`` in place.

    ``train_data`` and each of ``eval_sets[name]`` map keys to arrays or
    tensors of equal length, with a ``label`` and an optional ``weight``
    mask column (0 = padding row). ``generator`` is a ``torch.Generator`` on
    the model's device, or an int seed for one. ``hyper`` ({'lr', 'wd'})
    overrides the config's optimizer hyperparameters."""
    E = num_epochs or cfg.num_epochs
    if cfg.selection != "train_loss" and cfg.selection not in eval_names:
        raise ValueError(
            f"cfg.selection={cfg.selection!r} but eval_names={eval_names}; "
            "pass the selection set or use selection='train_loss'")
    if param_sharding is not None:
        raise NotImplementedError(f"param_sharding {_NOT_PORTED}")
    _check_supported(cfg)
    metric_mode_max = cfg.selection != "train_loss"

    def fit(generator: Union[torch.Generator, int], train_data, eval_sets,
            class_weights=None, hyper: Optional[dict] = None,
            resume_carry=None) -> FitResult:
        if resume_carry is not None:
            raise NotImplementedError(f"resume_carry {_NOT_PORTED}")
        dev = next(model.parameters()).device
        if isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator)
        lr = float((hyper or {}).get("lr", cfg.learning_rate))
        wd = float((hyper or {}).get("wd", cfg.weight_decay))
        train_data = _to_device(train_data, dev)
        eval_sets = {name: _to_device(eval_sets[name], dev)
                     for name in eval_names}
        if class_weights is not None:
            class_weights = _as_tensor(class_weights, dev, torch.float32)
        n = next(iter(train_data.values())).shape[0]
        bsz = min(cfg.batch_size, n)
        steps = n // bsz
        used = steps * bsz
        step = TrainStep(model, cfg, task=task, loss_kwargs=loss_kwargs,
                         augment=augment, preprocess=preprocess)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        best_params, best_stats = _snapshot(model)
        best_metric, best_epoch = f32(-math.inf), torch.tensor(
            -1, dtype=torch.int32, device=dev)
        bad_epochs, stopped = 0, False
        plateau_best, plateau_bad = f32(math.inf), torch.tensor(0, device=dev)
        lr_scale = f32(1.0)
        history = []
        for epoch in range(E):
            perm = torch.randperm(n, generator=generator, device=dev)[:used]
            shuffled = {k: v[perm] for k, v in train_data.items()}
            if cfg.schedule == "warmup_cosine":
                lr_scale = _cosine_scale(cfg, epoch, dev)
            step_lr = lr * lr_scale.item()
            losses = []
            for s in range(steps):
                batch = {k: v[s * bsz:(s + 1) * bsz]
                         for k, v in shuffled.items()}
                losses.append(
                    step.frozen(batch, class_weights, generator) if stopped
                    else step(batch, class_weights, generator, step_lr, wd))
            train_loss = torch.stack(losses).mean()

            metrics_out = {"train_loss": train_loss, "lr_scale": lr_scale}
            sel_metric = -train_loss
            model.eval()
            for name in eval_names:
                data = eval_sets[name]
                with torch.no_grad():
                    out = model(**step.inputs(data))
                m = (regression_metrics if task == "regression"
                     else binary_classification_metrics)(
                    out.logits, data["label"], data.get("weight"))
                metrics_out.update({f"{name}_{k}": v for k, v in m.items()})
                if cfg.selection == name:
                    sel_metric = m["f1" if task == "classification" else "r2"]
            history.append(metrics_out)

            delta = cfg.min_delta if metric_mode_max else 0.0
            # the one read of the epoch
            improved = bool(sel_metric > best_metric + delta) and not stopped
            if improved:
                best_params, best_stats = _snapshot(model)
                best_metric = sel_metric.float().clone()
                best_epoch = torch.tensor(epoch, dtype=torch.int32, device=dev)
            bad_epochs = 0 if improved else bad_epochs + 1
            stopped = stopped or bad_epochs >= cfg.patience
            if cfg.schedule == "plateau":
                plateau_best, plateau_bad, lr_scale = _plateau_update(
                    cfg, plateau_best, plateau_bad, lr_scale, train_loss)

        model.eval()
        final_params, final_stats = _snapshot(model)
        return FitResult(
            params=best_params, batch_stats=best_stats,
            final_params=final_params, final_batch_stats=final_stats,
            best_metric=best_metric, best_epoch=best_epoch,
            history={k: torch.stack([h[k] for h in history])
                     for k in history[0]})

    return fit


def fit(model: nn.Module, cfg: TrainConfig, generator, train_data,
        eval_sets, class_weights=None, **kw) -> FitResult:
    """One-shot ``make_fit_fn(...)(...)`` over the given eval sets."""
    fn = make_fit_fn(model, cfg, eval_names=tuple(eval_sets.keys()), **kw)
    return fn(generator, train_data, eval_sets, class_weights)
