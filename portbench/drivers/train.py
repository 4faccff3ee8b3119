"""Training traffic: the port's ``TrainStep`` over batches drawn from a
cohort on the card, in a seeded order.

Parameters (the traffic mix's ``params``): ``batch``, ``T``, ``cohort``
(subjects on the card), ``lr``, ``wd``, ``clip``, ``loss`` (a
``TrainConfig.loss`` name), ``augment`` (keys z-scored and augmented by
``ops.augment.augment_temporal`` in the step, in order), ``checked_steps``
(the first steps the reference follows), ``warmup_steps`` (set-up steps,
the checked ones among them), and ``profile_steps`` (the traced sub-window).

Set-up builds one ``TrainStep`` with its model and AdamW state, drives it
from the seed through the checked steps (rows that all differ), keeping
each step's loss, the first step's logits (a forward hook on the model)
and gradient as AdamW's first moment holds it, and the parameters after
the last, then through the rest of the warm-up,
and hands that same object to the window. The window dispatches steps
without reading anything back and synchronises once at its end: the rate
is all the samples over all the window's time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from portbench.harness import compare, stats
from portbench.harness.cell import Context, Window, now
from portbench.harness.spans import Spans
from portbench.harness.trace import Capture, window as trace_window

BETA1 = 0.9


@dataclass
class State:
    step: Any
    model: Any
    data: Dict[str, torch.Tensor]
    order: torch.Tensor               # (steps, batch) row indices, cyclic
    params0: Dict[str, torch.Tensor]
    seeds: Dict[str, int]
    class_weights: Any
    gen: torch.Generator
    next: int = 0
    first: Dict[str, Any] = field(default_factory=dict)


def order(ctx: Context, n: int, batch: int, steps: int) -> torch.Tensor:
    """Row indices for ``steps`` batches: whole seeded permutations of the
    cohort, one after another, cut into batches."""
    g = torch.Generator().manual_seed(ctx.seed_for("order"))
    perms = [torch.randperm(n, generator=g)
             for _ in range(-(-steps * batch // n))]
    return torch.cat(perms)[:steps * batch].view(steps, batch)


def make_augment(keys: List[str]):
    from multimodal_eeg_fmri_tpu_torch.ops.augment import augment_temporal
    from multimodal_eeg_fmri_tpu_torch.ops.signal import zscore

    def augment(generator, batch):
        out = dict(batch)
        for k in keys:
            out[k] = augment_temporal(generator, zscore(batch[k], axis=(1, 2)))
        return out

    return augment


def batch_at(state: State, i: int) -> Dict[str, torch.Tensor]:
    idx = state.order[i % len(state.order)]
    return {k: v[idx] for k, v in state.data.items()}


def one(state: State, i: int) -> torch.Tensor:
    return state.step(batch_at(state, i), state.class_weights,
                      generator=state.gen)


def seed_draws(state: State, device) -> None:
    """Seed the generators the step draws from: the augmentation's and the
    device's default (dropout)."""
    state.gen.manual_seed(state.seeds["augment"])
    torch.manual_seed(state.seeds["dropout"])
    if device.type == "cuda":
        torch.cuda.manual_seed(state.seeds["dropout"])


def inputs(ctx: Context):
    """(model, params0, data, order, seeds): what the benchmark makes from
    the seed, for the program and the reference alike."""
    p = ctx.params
    model = ctx.builder.build(ctx.config, ctx.device, ctx.generator("weights"))
    params0 = {n: q.detach().clone() for n, q in model.named_parameters()}
    data = ctx.builder.cohort(ctx.config, p["cohort"], p["T"],
                              ctx.generator("cohort"), ctx.device)
    steps = p.get("order_steps", 4096)
    idx = order(ctx, p["cohort"], p["batch"], steps).to(ctx.device)
    seeds = {"augment": ctx.seed_for("augment"),
             "dropout": ctx.seed_for("dropout")}
    return model, params0, data, idx, seeds


def setup(ctx: Context) -> State:
    from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    p = ctx.params
    model, params0, data, idx, seeds = inputs(ctx)
    cfg = TrainConfig(batch_size=p["batch"], learning_rate=p["lr"],
                      weight_decay=p["wd"], grad_clip=p["clip"],
                      loss=p["loss"])
    augment = make_augment(p["augment"]) if p.get("augment") else None
    step = TrainStep(model, cfg, augment=augment)
    cw = (torch.ones(ctx.config["model"]["num_classes"], device=ctx.device)
          if p["loss"] == "weighted_ce" else None)
    state = State(step, model, data, idx, params0, seeds, cw,
                  torch.Generator(device=ctx.device))
    ctx.mark("model, cohort and train step")
    seed_draws(state, ctx.device)
    losses, logits = [], []
    # the first step's logits, as the model hands them on
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.logits.detach().clone()))
    for i in range(p["checked_steps"]):
        losses.append(one(state, i))
        if i == 0:
            hook.remove()
            # the first moment after one step is (1 − β1)·g; a step that
            # left no state gave the optimizer no gradient
            moments = step.optimizer.state
            state.first["grad1"] = {
                n: (moments[q]["exp_avg"].detach() / (1.0 - BETA1)
                    if "exp_avg" in moments.get(q, {})
                    else torch.zeros_like(q).detach())
                for n, q in step.named_params.items()}
    state.first["params"] = {n: q.detach().clone()
                             for n, q in step.named_params.items()}
    state.first["losses"] = losses
    state.first["logits1"] = logits[0]
    for i in range(p["checked_steps"], p["warmup_steps"]):
        one(state, i)
    state.next = p["warmup_steps"]
    ctx.sync()
    ctx.mark("checked and warm-up steps")
    return state


def _attention_recorder(records: list):
    from portbench.work.common import mha_work

    def on_call(label, module, args):
        if label != "attention":
            return
        q, k = args[0], args[1]
        records.append(mha_work(q.shape[0], q.shape[1], k.shape[1],
                                q.shape[2], module.num_heads,
                                args[0] is args[1] is args[2], True))

    return on_call


def measure(ctx: Context, state: State) -> Window:
    p = ctx.params
    ctx.sync()
    start = now()
    losses = []
    i = state.next
    while True:
        losses.append(one(state, i))
        i += 1
        if now() - start >= ctx.seconds:
            break
    ctx.sync()
    end = now()
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    steps = len(losses)
    batch = p["batch"]
    # forward and backward, the backward twice the forward's products
    flops = 3.0 * steps * batch * ctx.work.forward_flops(ctx.config, p["T"])
    win = Window(start, end, steps, steps, failed,
                 {"train_samples_per_s": stats.window_rate(steps * batch,
                                                           start, end)},
                 flops=flops)
    if ctx.trace:
        n = p["profile_steps"]
        with Capture(host=False) as device:
            for _ in range(n):
                one(state, i)
                i += 1
            ctx.sync()
        records: list = []
        with Spans([state.model], ctx.spans, backward=True,
                   on_call=_attention_recorder(records)):
            with Capture(host=True) as host:
                with trace_window():
                    for _ in range(n):
                        one(state, i)
                        i += 1
                    ctx.sync()
        win.trace, win.host_trace = device.trace, host.trace
        win.profiled_units = n
        win.attention = records
    state.next = i
    return win


def _program(state: State) -> dict:
    first = state.first
    return {"losses": [float(x) for x in first["losses"]],
            "logits1": first["logits1"], "grad1": first["grad1"],
            "params": first["params"]}


def _reference(ctx: Context, state: State, tf32: bool,
               fault: str = "") -> dict:
    """The reference's steps; with ``fault`` the reference put in the
    program's place with that fault planted: ``unchanged`` (a step that
    leaves the state as it is), ``half_batch`` (half of each batch left
    out, the mean over the rest)."""
    p = ctx.params
    batches = [batch_at(state, i) for i in range(p["checked_steps"])]
    if fault == "half_batch":
        batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                   for b in batches]
    frozen = fault == "unchanged"
    hyper = {"lr": 0.0 if frozen else p["lr"],
             "wd": 0.0 if frozen else p["wd"], "clip": p["clip"],
             "augment": p.get("augment", []),
             "class_weights": state.class_weights}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return ctx.reference.train_steps(ctx.config, state.params0, batches,
                                         hyper, state.seeds, ctx.device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _free(ctx: Context, state: State) -> None:
    state.step = state.model = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(ctx: Context, state: State, window: Window):
    prog = _program(state)
    _free(ctx, state)
    ref = _reference(ctx, state, tf32=False)
    return compare.training(prog, ref, state.params0, ctx.limits)


FAULTS = ("unchanged", "half_batch")


def control(ctx: Context, fault: str = ""):
    """The reference in TF32 in the program's place (or in f32 with
    ``fault`` planted), from the inputs a run of this seed makes."""
    _, params0, data, idx, seeds = inputs(ctx)
    cw = (torch.ones(ctx.config["model"]["num_classes"], device=ctx.device)
          if ctx.params["loss"] == "weighted_ce" else None)
    state = State(None, None, data, idx, params0, seeds, cw, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    low = _reference(ctx, state, tf32=not fault, fault=fault)
    ref = _reference(ctx, state, tf32=False)
    return compare.training(low, ref, state.params0, ctx.limits)
