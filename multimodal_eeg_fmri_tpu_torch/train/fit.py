"""Whole-run training (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/train/fit.py``.

``make_fit_fn(model, cfg, ...)`` returns ``fit(generator, train_data,
eval_sets, class_weights, hyper=None, resume_carry=None)``, which keeps the
JAX contract: a per-epoch shuffle from an explicit generator; ``augment``
in f32, then ``preprocess`` merged into the batch in train and eval; the
forward in train mode, the loss, the backward; clipping by global norm as
optax does; Adam (0.9, 0.999, 1e-8) with the update −(lr·lr_scale)·(adam +
wd·p) on every parameter; per-epoch metrics on each eval set in eval mode;
best-state selection; plateau or warmup-cosine LR; and early stopping that
keeps the epoch count, so that ``history`` has ``num_epochs`` entries, and
freezes params, BatchNorm statistics, optimizer state and the EMA once
stopped.

The other options of the config, as in the JAX package:

- The loss of a train step is the task loss plus the aux losses that
  Mixture-of-Experts layers leave in training mode (``ops.moe``), as the
  JAX package adds its sown "losses" collection.
- ``grad_accum = k`` splits each batch into k microbatches whose task
  losses are scaled by their share of the batch's effective weight, so that
  the summed f32 gradients are the full batch's, and whose aux losses are
  divided by k; BatchNorm's running statistics thread through the
  microbatches in order.
- ``ema_decay = d`` keeps a Polyak average of the params (not of the
  BatchNorm statistics), started at the initial params. Evaluation and
  selection use it with the raw statistics of the same epoch, so
  ``FitResult.params`` is the best EMA snapshot.
- ``compute_dtype = "bfloat16"`` runs the train-mode forward and backward on
  bf16 copies of the params and inputs (the inputs cast after
  ``preprocess``); master params, gradients, AdamW state and the running
  statistics stay f32, the losses reduce in f32, and evaluation runs in f32.
- ``resume_carry`` takes a result's ``carry`` (``FitCarry``), the whole
  training state, and continues from it: two runs of E₁ and E₂ epochs equal
  one of E₁+E₂.
- A model that carries a mesh trains SPMD: every rank calls ``fit`` with
  the same integer seed and the same data, but for a time axis sharded
  over a ring's seq axis (``parallel.input.shard_sequence``). Every rank's
  loss is the one global loss, and each gradient is summed over the mesh
  axes its parameter is replicated on and divided by the mesh's size
  (``parallel.collectives.reduce_grads_``), so that it is the global
  loss's gradient in the rank's shard, as GSPMD computes it; the clip's
  norm is the whole gradient's (``parallel.collectives.global_norm``). The
  loss history and the metrics come out the same on every rank.
- Where the mesh has a ``data`` axis the batch shards over it: each step
  takes the global batch (shuffled alike on every rank) and each rank
  runs its rows (``parallel.input.global_batch_tree``). What the JAX
  package computes over the global batch stays global: the weighted loss
  is the summed weighted loss over the summed weights, training-mode
  BatchNorm statistics and Mixture-of-Experts routing run over the whole
  batch (``parallel.mesh.batch_sharded``), and the eval metrics are taken
  on the logits gathered over the axis.
- ``param_sharding`` (``parallel.tensor.tp_param_constraint``,
  ``parallel.fsdp.fsdp_param_constraint``,
  ``parallel.expert.ep_param_constraint``) lays the model out in place
  before its optimizer is built; params, AdamW's moments, the best params
  and the EMA are then this rank's shards. A ``resume_carry`` of full
  tensors (a checkpoint's) is cut to the layout first
  (``parallel.layout.local_tree``).

Where the JAX package initialises params inside ``fit``, the module passed
in here carries its weights, the torch idiom: ``fit`` trains them in place
and leaves the module in eval mode at its final weights; ``FitResult.params``
and ``.batch_stats`` hold the best epoch's. The data moves to the model's
device once and stays there; the host reads a few scalars once per epoch
(selection and the learning rate), never per step. Dropout draws from the
default generator of the model's device, augmentation and shuffling from the
one given; the carry holds both states.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, NamedTuple, Optional, Tuple,
                    Union)

import torch
from torch import nn
from torch.func import functional_call

from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.core.profiling import annotate
from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor
from multimodal_eeg_fmri_tpu_torch.ops.losses import make_loss_fn
from multimodal_eeg_fmri_tpu_torch.ops.moe import (
    collect_aux_losses,
    total_aux_loss,
)
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    all_gather,
    global_norm,
    psum,
    reduce_grads_,
)
from multimodal_eeg_fmri_tpu_torch.parallel.input import global_batch_tree
from multimodal_eeg_fmri_tpu_torch.parallel.layout import (
    local_tree,
    param_axes,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    MeshPlan,
    batch_axis_of,
    batch_sharded,
)
from multimodal_eeg_fmri_tpu_torch.report.metrics import (
    binary_classification_metrics,
    regression_metrics,
)

# batch keys that are not model inputs
RESERVED_KEYS = ("label", "reg_label", "weight", "subject")

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Tensors = Dict[str, torch.Tensor]


def split_batch(batch: Tensors) -> Tensors:
    return {k: v for k, v in batch.items() if k not in RESERVED_KEYS}


class FitCarry(NamedTuple):
    """The whole training state at the end of a ``fit``; pass it back as
    ``resume_carry`` to continue. Tensors are on the model's device but for
    AdamW's step count (on the CPU, as AdamW keeps it) and the two generator
    states (CPU uint8). ``rng`` or ``torch_rng`` None leaves that generator
    as the caller has it (a carry converted from the JAX package)."""

    params: Tensors
    batch_stats: Tensors              # buffers: the BatchNorm statistics
    opt_state: Dict[str, Any]         # {"step", "exp_avg", "exp_avg_sq"}
    rng: Optional[torch.Tensor]       # shuffling / augmentation generator
    torch_rng: Optional[torch.Tensor]  # the device's default generator
    best_params: Tensors
    best_batch_stats: Tensors
    best_metric: torch.Tensor         # f32
    best_epoch: torch.Tensor          # int32
    bad_epochs: int                   # early-stopping counter
    stopped: bool
    plateau_best: torch.Tensor        # plateau-LR controller
    plateau_bad: torch.Tensor
    lr_scale: torch.Tensor
    epoch: int                        # epochs run so far
    ema_params: Optional[Tensors] = None  # Polyak average, if ema_decay > 0


class FitResult(NamedTuple):
    params: Tensors                        # best params, by parameter name
    batch_stats: Tensors                   # best buffers (BatchNorm stats)
    final_params: Tensors                  # last-epoch params
    final_batch_stats: Tensors
    best_metric: torch.Tensor
    best_epoch: torch.Tensor
    history: Tensors                       # per-epoch series, (num_epochs,)
    carry: Optional[FitCarry] = None       # the state to resume from


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


def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm/‖g‖ when the global norm ‖g‖
    reaches max_norm, as optax's ``clip_by_global_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). ``norm`` is ‖g‖ where the caller
    has it (a sharded gradient's). Returns ‖g‖; never syncs."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    """The train step's compute dtype; raises on a name it does not know."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def state_tensors(model: nn.Module,
                  tensors: Optional[Tensors] = None) -> Tensors:
    """Every parameter and buffer of ``model`` by state-dict name, detached,
    with ``tensors`` (params, buffers or both) standing in for its own: the
    first argument of an evaluation program
    (``make_fit_fn(eval_program=...)``)."""
    return {**{k: p.detach() for k, p in model.named_parameters()},
            **dict(model.named_buffers()), **(tensors or {})}


def _apply_eval(model: nn.Module, inputs: Tensors,
                params: Optional[Tensors] = None,
                program: Optional[Callable] = None):
    """The eval-mode forward without autograd, in f32; ``params``
    (parameters, buffers or both, by name) stand in for the module's own
    without touching them. ``program(tensors, inputs)`` (``state_tensors``
    and the model's inputs) runs it in the module's place."""
    model.eval()
    with torch.no_grad():
        if program is not None:
            return program(state_tensors(model, params), inputs)
        if params is None:
            return model(**inputs)
        return functional_call(model, params, (), inputs)


class TrainStep:
    """One optimizer step of ``make_fit_fn``: augment, preprocess, the
    forward in train mode (in ``cfg.compute_dtype``), the loss (over
    ``cfg.grad_accum`` microbatches), the backward, global-norm clipping and
    AdamW. Owns the optimizer. ``step(batch)`` returns the loss, a device
    scalar, without reading it back."""

    def __init__(self, model: nn.Module, cfg: TrainConfig, *,
                 task: str = "classification",
                 loss_kwargs: Optional[dict] = None,
                 augment: Optional[Callable] = None,
                 preprocess: Optional[Callable] = None):
        self.model, self.cfg, self.task = model, cfg, task
        self.augment, self.preprocess = augment, preprocess
        self.compute_dtype = compute_dtype(cfg)
        self.accum = max(int(cfg.grad_accum or 1), 1)
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
        # a model on a mesh: each rank's backward gives the gradient of the
        # sum of the ranks' (equal) losses in its own copy of a parameter,
        # through the collectives' transposes; the sum over the axes a
        # parameter is replicated on, over the mesh's size, is the
        # gradient of the loss (``reduce_grads_``)
        self.mesh = getattr(model, "mesh", None)
        self.sharded = param_axes(model) if self.mesh is not None else {}
        self.data_axis = batch_axis_of(self.mesh,
                                       getattr(model, "seq_axis", None))
        self.named_params = dict(model.named_parameters())
        self.params = list(self.named_params.values())
        # every parameter gets a gradient, zero where none flows (a frozen
        # encoder), so that Adam and the weight decay update it as optax does
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def inputs(self, batch: Tensors) -> Tensors:
        """The model inputs of a batch, with ``preprocess`` merged in."""
        if self.preprocess is not None:
            batch = {**batch, **self.preprocess(split_batch(batch))}
        return split_batch(batch)

    def forward(self, inputs: Tensors):
        """The train-mode forward; updates the BatchNorm running statistics.
        In bf16 it runs on bf16 copies of the params and floating inputs,
        cast inside the graph so that the gradients reach the f32 params."""
        self.model.train()
        if self.compute_dtype == torch.float32:
            return self.model(**inputs)
        dt = self.compute_dtype
        params = {k: p.to(dt) for k, p in self.named_params.items()}
        inputs = {k: v.to(dt) if v.is_floating_point() else v
                  for k, v in inputs.items()}
        return functional_call(self.model, params, (), inputs)

    def rows(self, batch: Tensors) -> Tensors:
        """This rank's rows of a global batch where the batch shards over
        the mesh's data axis; the batch itself otherwise."""
        if self.data_axis is None:
            return batch
        return global_batch_tree(MeshPlan(self.mesh,
                                          data_axis=self.data_axis), batch)

    def sharded_forward(self):
        """The context of this model's forwards: its batch's rows sharded
        over the data axis, where it has one."""
        return batch_sharded(self.mesh, self.data_axis)

    def losses(self, batch: Tensors, class_weights=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(task loss, Σ aux) of the forward in train mode on the global
        ``batch``, in f32: the aux losses the MoE layers leave
        (``ops.moe``), None without one. Over a data axis each rank runs its
        rows, and the task loss is Σ w·l / Σ w over the whole batch."""
        with annotate("mmef/step/forward"):
            local = self.rows(batch)
            with collect_aux_losses() as sink, self.sharded_forward():
                out = self.forward(self.inputs(local))
            task = self.loss_fn(out.logits, local["label"], class_weights,
                                local.get("weight"))
            if self.data_axis is not None:
                w = self._eff_weight(local, class_weights).sum()
                total = psum(torch.stack([task * w.clamp_min(1e-8), w]),
                             self.data_axis, self.mesh)
                task = total[0] / total[1].clamp_min(1e-8)
            return task, total_aux_loss(sink)

    def loss(self, batch: Tensors, class_weights=None) -> torch.Tensor:
        """The forward in train mode and the loss, task + Σ aux."""
        task, aux = self.losses(batch, class_weights)
        return task if aux is None else task + aux

    def _eff_weight(self, batch: Tensors, class_weights) -> torch.Tensor:
        """Per-row weight of the loss's own denominator (every loss reduces
        as Σ w·l / max(Σ w, 1e-8)), which makes accumulation exact."""
        label = batch["label"]
        sw = batch.get("weight")
        w = (torch.ones(label.shape[0], dtype=torch.float32,
                        device=label.device) if sw is None else sw.float())
        if (self.task != "regression" and self.cfg.loss == "weighted_ce"
                and class_weights is not None):
            w = w * class_weights.float()[label.long()]
        return w

    def objective(self, batch: Tensors, class_weights=None,
                  backward: bool = True) -> torch.Tensor:
        """The batch's loss, backpropagated into the params' ``.grad`` if
        ``backward``. Over k microbatches it is Σ_k (ŵ_k/W)·L_k + aux_k/k
        with ŵ_k the microbatch's clamped weight sum, W the batch's and
        aux_k the microbatch's aux loss: each microbatch's task gradient is
        scaled by its share, its aux averages, and the f32 gradients sum.
        Rows beyond micro·k are dropped."""
        if self.accum == 1:
            loss = self.loss(batch, class_weights)
            if backward:
                with annotate("mmef/step/backward"):
                    loss.backward()
            return loss.detach()
        k = self.accum
        micro = batch["label"].shape[0] // k
        w = self._eff_weight(batch, class_weights)[:micro * k]
        w_k = w.view(k, micro).sum(dim=1)
        scales = w_k.clamp_min(1e-8) / w_k.sum().clamp_min(1e-8)
        total = 0.0
        for i in range(k):
            mb = {key: v[i * micro:(i + 1) * micro]
                  for key, v in batch.items()}
            task, aux = self.losses(mb, class_weights)
            loss = scales[i] * task
            if aux is not None:
                loss = loss + aux / k
            if backward:
                with annotate("mmef/step/backward"):
                    loss.backward()
            total = total + loss.detach()
        return total

    def backward(self, batch: Tensors, class_weights=None) -> torch.Tensor:
        """The batch's loss, with its gradient in the params' ``.grad``
        (zeroed first): on a model with a mesh, each reduced over the axes
        its parameter is replicated on (``reduce_grads_``)."""
        self.optimizer.zero_grad(set_to_none=False)
        loss = self.objective(batch, class_weights)
        if self.mesh is not None:
            reduce_grads_({n: p.grad for n, p in self.named_params.items()},
                          self.sharded, self.mesh)
        return loss

    def grad_norm(self) -> torch.Tensor:
        """‖g‖ of the whole gradient (every shard's, once)."""
        return global_norm({n: p.grad for n, p in self.named_params.items()},
                           self.sharded, self.mesh)

    def __call__(self, batch, class_weights=None,
                 generator: Optional[torch.Generator] = None,
                 lr: Optional[float] = None,
                 wd: Optional[float] = None) -> torch.Tensor:
        if self.augment is not None:
            with annotate("mmef/step/augment"):
                batch = self.augment(generator, batch)
        loss = self.backward(batch, class_weights)
        if self.cfg.grad_clip and self.cfg.grad_clip > 0:
            with annotate("mmef/step/clip"):
                clip_by_global_norm_([p.grad for p in self.params],
                                     self.cfg.grad_clip, self.grad_norm())
        with annotate("mmef/step/optimizer"):
            group = self.optimizer.param_groups[0]
            group["lr"] = self.cfg.learning_rate if lr is None else lr
            group["weight_decay"] = (self.cfg.weight_decay if wd is None
                                     else wd)
            self.optimizer.step()
        return loss

    @torch.no_grad()
    def frozen(self, batch, class_weights=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of a step taken after early stopping: params,
        optimizer state and BatchNorm statistics stay as they are."""
        if self.augment is not None:
            batch = self.augment(generator, batch)
        buffers = [b.clone() for b in self.model.buffers()]
        loss = self.objective(batch, class_weights, backward=False)
        for b, saved in zip(self.model.buffers(), buffers):
            b.copy_(saved)
        return loss

    def opt_state(self) -> Dict[str, Any]:
        """AdamW's state by parameter name (zeros before the first step)."""
        state = self.optimizer.state
        steps = [s["step"] for s in state.values() if "step" in s]
        step = steps[0].clone() if steps else torch.tensor(0.0)

        def moment(key):
            return {n: (state[p][key].clone() if key in state.get(p, {})
                        else torch.zeros_like(p).detach())
                    for n, p in self.named_params.items()}

        return {"step": step, "exp_avg": moment("exp_avg"),
                "exp_avg_sq": moment("exp_avg_sq")}

    def load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        step = torch.as_tensor(opt_state["step"], dtype=torch.float32).cpu()
        for n, p in self.named_params.items():
            self.optimizer.state[p] = {
                "step": step.clone(),
                "exp_avg": opt_state["exp_avg"][n].to(p.device, p.dtype,
                                                      copy=True),
                "exp_avg_sq": opt_state["exp_avg_sq"][n].to(
                    p.device, p.dtype, copy=True)}


def _snapshot(model: nn.Module) -> Tuple[Tensors, Tensors]:
    """(params, the other state-dict tensors), cloned."""
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k not in params}
    return params, stats


def _cloned(tensors: Optional[Tensors], device) -> Optional[Tensors]:
    if tensors is None:
        return None
    return {k: v.to(device, copy=True) for k, v in tensors.items()}


@torch.no_grad()
def _ema_update(ema: Tensors, params: Tensors, decay: float) -> None:
    """ema ← d·ema + (1−d)·params, rounded as the JAX package rounds it."""
    e = list(ema.values())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul([params[k] for k in ema],
                                              1.0 - decay))


def _device_rng_state(device: torch.device) -> torch.Tensor:
    """State of the default generator of ``device`` (dropout draws there)."""
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_device_rng_state(device: torch.device, state: torch.Tensor) -> None:
    state = state.cpu()
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def initial_carry(model: nn.Module, ema: bool = False) -> FitCarry:
    """The carry of a run that has not begun: the module's weights and
    statistics, zero AdamW state, no best epoch yet, and the generators
    left as the caller has them."""
    dev = next(model.parameters()).device
    params, stats = _snapshot(model)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return FitCarry(
        params=params, batch_stats=stats,
        opt_state={"step": torch.tensor(0.0),
                   "exp_avg": {k: torch.zeros_like(v)
                               for k, v in params.items()},
                   "exp_avg_sq": {k: torch.zeros_like(v)
                                  for k, v in params.items()}},
        rng=None, torch_rng=None,
        best_params=_cloned(params, dev), best_batch_stats=_cloned(stats, dev),
        best_metric=f32(-math.inf),
        best_epoch=torch.tensor(-1, dtype=torch.int32, device=dev),
        bad_epochs=0, stopped=False, plateau_best=f32(math.inf),
        plateau_bad=torch.tensor(0, device=dev), lr_scale=f32(1.0), epoch=0,
        ema_params=_cloned(params, dev) if ema else None)


def localize_carry(model: nn.Module, carry: FitCarry) -> FitCarry:
    """``carry`` with every tree by parameter or state-dict name cut to the
    model's layout where it holds full tensors (a checkpoint's)."""
    def cut(tree):
        return local_tree(model, tree)

    return carry._replace(
        params=cut(carry.params), batch_stats=cut(carry.batch_stats),
        best_params=cut(carry.best_params),
        best_batch_stats=cut(carry.best_batch_stats),
        ema_params=cut(carry.ema_params),
        opt_state={**carry.opt_state,
                   "exp_avg": cut(carry.opt_state["exp_avg"]),
                   "exp_avg_sq": cut(carry.opt_state["exp_avg_sq"])})


def _to_device(data, device) -> Tensors:
    return {k: as_tensor(v, device) for k, v in data.items()}


def make_fit_fn(model: nn.Module, cfg: TrainConfig, *,
                num_epochs: Optional[int] = None,
                task: str = "classification",
                eval_names: Tuple[str, ...] = ("val", "test"),
                loss_kwargs: Optional[dict] = None,
                augment: Optional[Callable] = None,
                preprocess: Optional[Callable] = None,
                param_sharding: Optional[Callable] = None,
                eval_program: Optional[Callable] = None
                ) -> Callable[..., FitResult]:
    """Build ``fit(generator, train_data, eval_sets, class_weights=None,
    hyper=None, resume_carry=None)`` that trains ``model`` in place.

    ``train_data`` and each of ``eval_sets[name]`` map keys to arrays or
    tensors of equal length, with a ``label`` and an optional ``weight``
    mask column (0 = padding row). ``generator`` is a ``torch.Generator`` on
    the model's device, or an int seed for one; with ``resume_carry`` it
    takes the carry's state. ``hyper`` ({'lr', 'wd'}) overrides the config's
    optimizer hyperparameters. ``num_epochs`` (default ``cfg.num_epochs``)
    is the epochs of this call; the cosine schedule reads the global epoch
    against ``cfg.num_epochs``. ``param_sharding`` (``model → model``)
    lays the model out before its optimizer is built, on every call.
    ``eval_program(tensors, inputs)`` (``state_tensors`` and the model's
    inputs; a loaded ``core.aot`` bundle) computes the per-epoch evaluations
    in the module's place: it must compute the module's eval-mode forward."""
    E = num_epochs or cfg.num_epochs
    if cfg.selection != "train_loss" and cfg.selection not in eval_names:
        raise ValueError(
            f"cfg.selection={cfg.selection!r} but eval_names={eval_names}; "
            "pass the selection set or use selection='train_loss'")
    compute_dtype(cfg)
    metric_mode_max = cfg.selection != "train_loss"
    accum = max(int(cfg.grad_accum or 1), 1)
    ema_d = float(cfg.ema_decay or 0.0)

    def fit(generator: Union[torch.Generator, int], train_data, eval_sets,
            class_weights=None, hyper: Optional[dict] = None,
            resume_carry: Optional[FitCarry] = None) -> FitResult:
        if param_sharding is not None:
            param_sharding(model)
        dev = next(model.parameters()).device
        if isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator)
        lr = float((hyper or {}).get("lr", cfg.learning_rate))
        wd = float((hyper or {}).get("wd", cfg.weight_decay))
        train_data = _to_device(train_data, dev)
        eval_sets = {name: _to_device(eval_sets[name], dev)
                     for name in eval_names}
        if class_weights is not None:
            class_weights = as_tensor(class_weights, dev, torch.float32)
        n = next(iter(train_data.values())).shape[0]
        bsz = min(cfg.batch_size, n)
        steps = n // bsz
        used = steps * bsz
        if accum > 1 and bsz % accum:
            raise ValueError(f"grad_accum={accum} must divide the "
                             f"(effective) batch size {bsz}")
        step = TrainStep(model, cfg, task=task, loss_kwargs=loss_kwargs,
                         augment=augment, preprocess=preprocess)
        if step.data_axis is not None:
            n_data = step.mesh.shape[step.data_axis]
            if (bsz // accum) % n_data:
                raise ValueError(
                    f"the (micro)batch of {bsz // accum} rows does not "
                    f"divide the {step.data_axis!r} axis ({n_data})")

        c = resume_carry
        if c is None:
            c = initial_carry(model, ema=ema_d > 0)
        elif step.mesh is not None:
            c = localize_carry(model, c)
        model.load_state_dict({**c.params, **c.batch_stats})
        step.load_opt_state(c.opt_state)
        if c.rng is not None:
            generator.set_state(c.rng.cpu())
        if c.torch_rng is not None:
            _set_device_rng_state(dev, c.torch_rng)
        best_params = _cloned(c.best_params, dev)
        best_stats = _cloned(c.best_batch_stats, dev)
        best_metric = c.best_metric.to(dev, torch.float32, copy=True)
        best_epoch = c.best_epoch.to(dev, torch.int32, copy=True)
        bad_epochs, stopped, epoch0 = (int(c.bad_epochs), bool(c.stopped),
                                       int(c.epoch))
        plateau_best = c.plateau_best.to(dev, torch.float32, copy=True)
        plateau_bad = c.plateau_bad.to(dev, copy=True)
        lr_scale = c.lr_scale.to(dev, torch.float32, copy=True)
        # a carry without an average (EMA off when it was made) seeds it
        # from its params, as a fresh run seeds it from the initial ones
        ema = (_cloned(c.ema_params if c.ema_params is not None
                       else c.params, dev) if ema_d > 0 else None)

        history = []
        for epoch in range(epoch0, epoch0 + E):
            perm = torch.randperm(n, generator=generator, device=dev)[:used]
            shuffled = {k: v[perm] for k, v in train_data.items()}
            if cfg.schedule == "warmup_cosine":
                lr_scale = _cosine_scale(cfg, epoch, dev)
            step_lr = lr * lr_scale.item()
            losses = []
            for s in range(steps):
                batch = {k: v[s * bsz:(s + 1) * bsz]
                         for k, v in shuffled.items()}
                if stopped:
                    losses.append(step.frozen(batch, class_weights,
                                              generator))
                    continue
                losses.append(step(batch, class_weights, generator, step_lr,
                                   wd))
                if ema is not None:
                    _ema_update(ema, step.named_params, ema_d)
            train_loss = torch.stack(losses).mean()

            metrics_out = {"train_loss": train_loss, "lr_scale": lr_scale}
            sel_metric = -train_loss
            for name in eval_names:
                data = eval_sets[name]
                with step.sharded_forward():
                    logits = _apply_eval(model, step.inputs(step.rows(data)),
                                         ema, eval_program).logits
                if step.data_axis is not None:
                    logits = all_gather(logits, step.data_axis, 0, step.mesh)
                m = (regression_metrics if task == "regression"
                     else binary_classification_metrics)(
                    logits, data["label"], data.get("weight"))
                metrics_out.update({f"{name}_{k}": v for k, v in m.items()})
                if cfg.selection == name:
                    sel_metric = m["f1" if task == "classification" else "r2"]
            history.append(metrics_out)

            delta = cfg.min_delta if metric_mode_max else 0.0
            # the one read of the epoch
            improved = bool(sel_metric > best_metric + delta) and not stopped
            if improved:
                params, best_stats = _snapshot(model)
                best_params = _cloned(ema, dev) if ema is not None else params
                best_metric = sel_metric.float().clone()
                best_epoch = torch.tensor(epoch, dtype=torch.int32, device=dev)
            bad_epochs = 0 if improved else bad_epochs + 1
            stopped = stopped or bad_epochs >= cfg.patience
            if cfg.schedule == "plateau":
                plateau_best, plateau_bad, lr_scale = _plateau_update(
                    cfg, plateau_best, plateau_bad, lr_scale, train_loss)

        model.eval()
        final_params, final_stats = _snapshot(model)
        carry = FitCarry(
            params=final_params, batch_stats=final_stats,
            opt_state=step.opt_state(), rng=generator.get_state(),
            torch_rng=_device_rng_state(dev), best_params=best_params,
            best_batch_stats=best_stats, best_metric=best_metric,
            best_epoch=best_epoch, bad_epochs=bad_epochs, stopped=stopped,
            plateau_best=plateau_best, plateau_bad=plateau_bad,
            lr_scale=lr_scale, epoch=epoch0 + E,
            ema_params=_cloned(ema, dev))
        return FitResult(
            params=best_params, batch_stats=best_stats,
            final_params=final_params, final_batch_stats=final_stats,
            best_metric=best_metric, best_epoch=best_epoch,
            history={k: torch.stack([h[k] for h in history])
                     for k in history[0]} if history else {},
            carry=carry)

    return fit


def fit(model: nn.Module, cfg: TrainConfig, generator, train_data,
        eval_sets, class_weights=None, **kw) -> FitResult:
    """One-shot ``make_fit_fn(...)(...)`` over the given eval sets."""
    fn = make_fit_fn(model, cfg, eval_names=tuple(eval_sets.keys()), **kw)
    return fn(generator, train_data, eval_sets, class_weights)
