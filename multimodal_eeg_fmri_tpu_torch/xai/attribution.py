"""Gradient-based attribution, batched on the model's device (PyTorch).
Counterpart of ``multimodal_eeg_fmri_tpu/xai/attribution.py``.

Reference equivalents (SURVEY §2.2):
- vanilla gradient / gradient×input: ``eeg_xai_analysis.py:97-152``,
  ``bridge_utils.py:158-182`` — one-hot backward per sample on host.
- Integrated gradients: ``eeg_xai_analysis.py:155-236``,
  ``bridge_utils.py:189-229`` — a PYTHON LOOP of 50 forward+backward passes
  per sample (the reference's inner hot loop, SURVEY §3.3).
- Ablation channel importance: ``CrossModal_EEG_scr.ipynb §45`` — zero one
  channel at a time, measure probability drop.

Attribution of a batch with respect to EVERY input modality is one
``torch.autograd.grad`` of the selected logit sum (per-sample gradients fall
out because each logit depends only on its own row). Where the JAX package
vmaps IG's interpolation steps and the ablation masks, the port folds that
axis into the batch: one forward and one backward over ``n_steps × B`` (or
``n_ch × B``) rows. Eval mode makes rows independent (BatchNorm on its
running statistics, no dropout), so folding is exact; on the card, at T ≥
512, the flash kernels take the folded batch in one launch each.

All functions take ``apply_fn(inputs) -> logits`` where ``inputs`` is a dict
of modality tensors — build one with ``make_apply_fn``. They return tensors
on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor

Tensors = Dict[str, torch.Tensor]
ApplyFn = Callable[[Tensors], torch.Tensor]


def make_apply_fn(model: nn.Module, params: Optional[Tensors] = None,
                  batch_stats: Optional[Tensors] = None) -> ApplyFn:
    """Wrap a model into ``apply_fn(inputs_dict) -> logits`` in eval mode,
    with ``params`` and ``batch_stats`` (dicts by state-dict name, as in
    ``FitResult``; None takes the module's own) through
    ``torch.func.functional_call``. The weights are detached: gradients
    reach the inputs only, no parameter's ``.grad`` is written, the module's
    own weights are not touched and its ``training`` flag is left as it
    was. ``apply_fn.device`` is the model's device."""
    device = next(model.parameters()).device
    params = dict(model.named_parameters()) if params is None else params
    stats = dict(model.named_buffers()) if batch_stats is None else batch_stats
    tensors = {k: v.detach() for k, v in {**params, **stats}.items()}

    def apply_fn(inputs: Tensors) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            return functional_call(
                model, tensors, (),
                {k: as_tensor(v, device) for k, v in inputs.items()}).logits
        finally:
            model.train(was_training)

    apply_fn.device = device
    return apply_fn


def _on_device(apply_fn: ApplyFn, inputs) -> Tensors:
    return {k: as_tensor(v, apply_fn.device) for k, v in inputs.items()}


def _target_classes(apply_fn: ApplyFn, inputs: Tensors, target_class
                    ) -> torch.Tensor:
    """(B,) int64 classes: the argmax of one forward when ``target_class``
    is None, else the given class for every row or the given (B,) classes
    (no forward)."""
    if target_class is None:
        with torch.no_grad():
            return apply_fn(inputs).argmax(dim=-1)
    t = torch.as_tensor(target_class, device=apply_fn.device).long()
    if t.dim() == 0:
        return t.expand(next(iter(inputs.values())).shape[0])
    return t


def _selected_logit_grads(apply_fn: ApplyFn, inputs: Tensors,
                          targets: torch.Tensor) -> Tensors:
    """∂ Σ_b logit[b, targets[b]] / ∂ inputs, one forward and one backward."""
    leaves = {k: v.detach().requires_grad_() for k, v in inputs.items()}
    with torch.enable_grad():
        logits = apply_fn(leaves)
        total = logits.gather(-1, targets[:, None]).sum()
        grads = torch.autograd.grad(total, tuple(leaves.values()))
    return dict(zip(leaves, grads))


def gradient_saliency(
    apply_fn: ApplyFn,
    inputs: Tensors,
    target_class=None,
    absolute: bool = True,
) -> Tensors:
    """|∂ logit_target / ∂ input| per modality, whole batch in one
    backward."""
    inputs = _on_device(apply_fn, inputs)
    targets = _target_classes(apply_fn, inputs, target_class)
    grads = _selected_logit_grads(apply_fn, inputs, targets)
    return {k: g.abs() for k, g in grads.items()} if absolute else grads


def gradient_x_input(
    apply_fn: ApplyFn,
    inputs: Tensors,
    target_class=None,
) -> Tensors:
    """|input ⊙ gradient| (reference ``gradient_x_input``)."""
    inputs = _on_device(apply_fn, inputs)
    grads = gradient_saliency(apply_fn, inputs, target_class, absolute=False)
    return {k: (g * inputs[k]).abs() for k, g in grads.items()}


def _fold(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) → (n·B, ...): ``x`` repeated n times along a leading axis
    folded into the batch."""
    return x.expand(n, *x.shape).reshape(n * x.shape[0], *x.shape[1:])


def integrated_gradients(
    apply_fn: ApplyFn,
    inputs: Tensors,
    target_class=None,
    baselines: Optional[Tensors] = None,
    n_steps: int = 50,
    frozen_keys: tuple = (),
) -> Tensors:
    """IG with the reference's left-Riemann rule over α ∈ linspace(0,1,n):
    attribution = (x − x₀) ⊙ meanₐ ∇f(x₀ + α(x − x₀)).

    The α axis is folded into the batch: one forward and one backward over
    ``n_steps × B`` rows (α-major), then the mean over α. (The reference
    runs a host loop of 50 separate backward passes per sample — SURVEY
    §3.3 inner hot loop.)

    ``frozen_keys``: modalities held at their FULL value at every α step
    (not interpolated) but still attributed as x ⊙ meanₐ ∇. This reproduces
    the reference EEG estimator, which never interpolates ``conn``
    (``eeg_xai_analysis.py:203-204`` — ``conn_interp = conn.clone()`` inside
    the α loop) while still multiplying by the full conn value (:233-234).
    The default (interpolate everything) is the axiomatically-correct form
    the bridge estimator uses (``bridge_utils.py:209-227``).
    """
    inputs = _on_device(apply_fn, inputs)
    baselines = ({k: torch.zeros_like(v) for k, v in inputs.items()}
                 if baselines is None else _on_device(apply_fn, baselines))
    targets = _target_classes(apply_fn, inputs, target_class)
    diffs = {k: inputs[k] - baselines[k] for k in inputs}
    alphas = torch.linspace(0.0, 1.0, n_steps, device=apply_fn.device)

    def interpolated(k: str) -> torch.Tensor:
        if k in frozen_keys:
            return _fold(inputs[k], n_steps)
        a = alphas.view(n_steps, *([1] * inputs[k].dim()))
        x = baselines[k][None] + a * diffs[k][None]     # (n_steps, B, ...)
        return x.reshape(n_steps * x.shape[1], *x.shape[2:])

    grads = _selected_logit_grads(
        apply_fn, {k: interpolated(k) for k in inputs},
        targets.repeat(n_steps))
    # frozen keys multiply by the FULL value (the reference's :233-234
    # ``conn * avg_grads``), interpolated keys by (x − baseline); the two
    # only coincide for the zero baseline
    return {
        k: ((inputs[k] if k in frozen_keys else diffs[k])
            * grads[k].view(n_steps, *inputs[k].shape).mean(dim=0)).abs()
        for k in inputs
    }


def ablation_importance(
    apply_fn: ApplyFn,
    inputs: Tensors,
    key: str,
    axis: int = -1,
    target_class=None,
) -> torch.Tensor:
    """Channel-ablation importance for ``inputs[key]`` along ``axis``:
    drop in target-class probability when a channel is zeroed
    (reference ``compute_channel_importance``). All channels ablate in one
    forward over ``n_ch × B`` rows — (n_ch, B) probability drops →
    (B, n_ch).
    """
    inputs = _on_device(apply_fn, inputs)
    targets = _target_classes(apply_fn, inputs, target_class)

    def prob_target(inp: Tensors, t: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(apply_fn(inp).float(), dim=-1)
        return p.gather(-1, t[:, None])[:, 0]

    x = inputs[key]
    n_ch = x.shape[axis]
    shape = [1] * (x.dim() + 1)
    shape[0] = n_ch
    shape[1 + axis % x.dim()] = n_ch
    masks = (1.0 - torch.eye(n_ch, dtype=x.dtype, device=x.device)).view(shape)
    folded = {k: _fold(v, n_ch) for k, v in inputs.items() if k != key}
    folded[key] = (x[None] * masks).reshape(n_ch * x.shape[0], *x.shape[1:])
    with torch.no_grad():
        base = prob_target(inputs, targets)
        dropped = prob_target(folded, targets.repeat(n_ch)).view(n_ch, -1)
    return (base[None, :] - dropped).T  # (B, n_ch)
