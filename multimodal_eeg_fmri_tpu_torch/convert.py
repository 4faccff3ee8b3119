"""Weights between the JAX package and the port.

``load_flax_variables`` fills a port module from the flax variable trees of
its JAX counterpart, given as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, variables)`` gives). It is strict: a flax leaf
that nothing takes, or a port tensor that nothing fills, raises.

``flax_variables_from_module`` is its inverse: a port module's weights as
flax variable trees, for the int8/int4 payloads of ``core/quantize.py``.

``carry_from_jax`` turns the training state of a JAX ``fit``
(``FitResult.carry`` with numpy leaves) into the port's ``FitCarry``, so
that the port's ``fit`` can resume a run the JAX package began.

``init_weights`` initialises a port module as flax would: lecun-normal
kernels (a normal truncated at ±2σ, rescaled to unit variance over fan-in),
zero biases, unit norm scales, and the special initial values of
``LearnedFusion``, ``FMRIFusionNet`` and ``HybridFusion``; the MoE
experts' stacked kernels count their leading expert axis into fan-in, as
flax's ``lecun_normal`` does (D·E for ``w1`` (E, D, ff), ff·E for
``w2``). The numbers come from an explicit CPU ``torch.Generator``, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.models.encoders import MultiScaleConv
from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
from multimodal_eeg_fmri_tpu_torch.models.fusion import (
    HybridFusion,
    LearnedFusion,
)
from multimodal_eeg_fmri_tpu_torch.models.long_context import (
    PipelinedLongContextClassifier,
)
from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN
from multimodal_eeg_fmri_tpu_torch.parallel.layout import flax_layout
from multimodal_eeg_fmri_tpu_torch.train.fit import FitCarry

# flax's truncated_normal initialisers divide by this: the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _leaves(tree: Mapping, prefix: str) -> set:
    out = set()
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out |= _leaves(v, path) if isinstance(v, Mapping) else {path}
    return out


class _Loader:
    def __init__(self):
        self.used: set = set()
        self.filled: set = set()

    def take(self, tree: Optional[Mapping], path: Tuple[str, ...],
             root: str) -> np.ndarray:
        node = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"flax variables have no leaf "
                                 f"{root}/{'/'.join(path)}")
            node = node[key]
        self.used.add(f"{root}/{'/'.join(path)}")
        return np.asarray(node)

    def put(self, tensor: torch.Tensor, value: np.ndarray, name: str):
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: flax shape {value.shape} != port "
                             f"shape {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.array(value)))
        self.filled.add(name)


def _batch_norms(module: nn.Module):
    """(state-dict prefix, flax path, BatchNorm) of each BatchNorm, whose
    running statistics flax keeps in ``batch_stats`` as ``mean``/``var``."""
    for name, m in module.named_modules():
        if isinstance(m, nn.BatchNorm1d):
            yield (f"{name}." if name else "",
                   tuple(name.split(".")) if name else (), m)


def _unstacked(module: nn.Module, params: Mapping) -> Mapping:
    """``params`` with a ``PipelinedLongContextClassifier``'s stacked
    ``blocks`` (leading axis: the layer) cut into the layers the module
    holds: all of them in the twin, its own on a stage rank."""
    if not isinstance(module, PipelinedLongContextClassifier):
        return params

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, Mapping) else
                np.asarray(v)[i] for k, v in tree.items()}

    return {**params, "blocks": {k: layer(params["blocks"], int(k))
                                 for k in module.blocks}}


def load_flax_variables(module: nn.Module, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``module``'s parameters and buffers from flax ``params`` and
    ``batch_stats``; returns the module. A pipelined classifier takes the
    JAX package's stacked ``blocks``: the twin every layer, a stage rank
    its own."""
    params = _unstacked(module, params)
    loader = _Loader()
    for name, leaf in flax_layout(module).items():
        loader.put(module.get_parameter(name),
                   leaf.port_array(loader.take(params, leaf.path, "params")),
                   name)
    for prefix, path, bn in _batch_norms(module):
        for key, buf in (("mean", "running_mean"), ("var", "running_var")):
            loader.put(getattr(bn, buf),
                       loader.take(batch_stats, path + (key,), "batch_stats"),
                       prefix + buf)
    unused = (_leaves(params, "params")
              | _leaves(batch_stats or {}, "batch_stats")) - loader.used
    if unused:
        raise ValueError(f"flax leaves not used by the port: {sorted(unused)}")
    unfilled = {k for k in module.state_dict()
                if not k.endswith("num_batches_tracked")} - loader.filled
    if unfilled:
        raise ValueError(f"port tensors not filled: {sorted(unfilled)}")
    return module


def _flax_trees(module: nn.Module) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``module`` in flax layout; the inverse of
    ``load_flax_variables``."""
    def host(t):
        return t.detach().cpu().numpy()

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = np.array(value)

    params, stats = {}, {}
    for name, leaf in flax_layout(module).items():
        put(params, leaf.path,
            leaf.flax_array(host(module.get_parameter(name))))
    for _, path, bn in _batch_norms(module):
        put(stats, path + ("mean",), host(bn.running_mean))
        put(stats, path + ("var",), host(bn.running_var))
    return params, stats


def flax_variables_from_module(module: nn.Module) -> dict:
    """``{"params", "batch_stats"}`` of ``module`` as nested dicts of numpy
    arrays in flax layout, the inverse of ``load_flax_variables``: what the
    JAX counterpart's ``init`` would give for these weights, so that
    ``core.quantize.save_quantized`` writes the JAX package's payload."""
    params, stats = _flax_trees(module)
    if isinstance(module, PipelinedLongContextClassifier):
        if module.mesh is not None:
            raise ValueError(
                "flax_variables_from_module takes the sequential twin: load "
                "a stage rank's full_state_dict() into one")
        layers = [params["blocks"][str(i)] for i in range(module.num_layers)]

        def stack(trees):
            return {k: stack([t[k] for t in trees])
                    if isinstance(trees[0][k], dict) else
                    np.stack([t[k] for t in trees]) for k in trees[0]}

        params["blocks"] = stack(layers)
    return {"params": params, "batch_stats": stats}


def _port_tensors(module: nn.Module, params: Mapping,
                  batch_stats: Optional[Mapping]) -> Tuple[dict, dict]:
    """(params, other state-dict tensors) of ``module``'s layout, by name,
    filled from flax trees; ``module`` itself is left as it is."""
    scratch = load_flax_variables(copy.deepcopy(module), params, batch_stats)
    out = {k: p.detach().clone() for k, p in scratch.named_parameters()}
    stats = {k: v.clone() for k, v in scratch.state_dict().items()
             if k not in out}
    return out, stats


def _adam_state(opt_state: Any):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def carry_from_jax(module: nn.Module, carry: Any) -> FitCarry:
    """The port's ``FitCarry`` from a JAX ``FitResult.carry`` with numpy
    leaves, for ``module``'s layout and device. optax's Adam state maps onto
    AdamW's (count → step, mu → exp_avg, nu → exp_avg_sq); the scalars are
    copied. The JAX PRNG key has no torch counterpart: ``rng`` and
    ``torch_rng`` are None, so the resumed ``fit`` keeps the generators the
    caller gives it."""
    dev = next(module.parameters()).device
    adam = _adam_state(carry.opt_state)
    if adam is None:
        raise ValueError("the carry's opt_state holds no Adam state")

    def port(params, stats=carry.batch_stats):
        p, s = _port_tensors(module, params, stats)
        return ({k: v.to(dev) for k, v in p.items()},
                {k: v.to(dev) for k, v in s.items()})

    def scalar(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    params, batch_stats = port(carry.params)
    best_params, best_stats = port(carry.best_params, carry.best_batch_stats)
    ema = carry.ema_params
    return FitCarry(
        params=params, batch_stats=batch_stats,
        opt_state={"step": torch.tensor(float(np.asarray(adam.count))),
                   "exp_avg": port(adam.mu)[0],
                   "exp_avg_sq": port(adam.nu)[0]},
        rng=None, torch_rng=None,
        best_params=best_params, best_batch_stats=best_stats,
        best_metric=scalar(carry.best_metric, torch.float32),
        best_epoch=scalar(carry.best_epoch, torch.int32),
        bad_epochs=int(np.asarray(carry.bad_epochs)),
        stopped=bool(np.asarray(carry.stopped)),
        plateau_best=scalar(carry.plateau_best, torch.float32),
        plateau_bad=scalar(carry.plateau_bad, torch.int64),
        lr_scale=scalar(carry.lr_scale, torch.float32),
        epoch=int(np.asarray(carry.epoch)),
        ema_params=port(ema)[0] if isinstance(ema, Mapping) and ema
        else None)


def _lecun_normal(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    sample = torch.empty(tensor.shape, dtype=torch.float32)
    nn.init.trunc_normal_(sample, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    tensor.copy_(sample)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and norm buffer of ``module`` as flax
    does; returns the module."""
    done = set()
    for sub in module.modules():
        own = dict(sub.named_parameters(recurse=False))
        if isinstance(sub, nn.Linear):
            _lecun_normal(sub.weight, sub.in_features, generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Conv1d):
            _lecun_normal(sub.weight, sub.weight[0].numel(), generator)
            sub.bias.zero_()
        elif isinstance(sub, (nn.LayerNorm, nn.BatchNorm1d)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
            if isinstance(sub, nn.BatchNorm1d):
                sub.reset_running_stats()
        elif isinstance(sub, MultiScaleConv):
            _lecun_normal(sub.kernel, sub.kernel.shape[0] * sub.kernel.shape[1],
                          generator)
            sub.bias.zero_()
        elif isinstance(sub, MoEFFN):
            for w, b in ((sub.w1, sub.b1), (sub.w2, sub.b2)):
                _lecun_normal(w, w.shape[0] * w.shape[1], generator)
                b.zero_()
        elif isinstance(sub, LearnedFusion):
            sub.fusion_logits.fill_(1.0)
            if sub.temperature is not None:
                sub.temperature.fill_(sub.init_temperature)
        elif isinstance(sub, FMRIFusionNet):
            sub.activation_weight.fill_(0.5)
            sub.connectivity_weight.fill_(0.5)
        elif isinstance(sub, HybridFusion):
            sub.final_gate.copy_(torch.tensor([0.6, 0.4]))
        elif own:
            raise TypeError(f"init_weights does not know {type(sub).__name__}")
        done |= {id(p) for p in own.values()}
    missed = [n for n, p in module.named_parameters() if id(p) not in done]
    if missed:
        raise TypeError(f"parameters left uninitialised: {missed}")
    return module
