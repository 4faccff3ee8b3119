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
from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention
from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN
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

    def take(self, tree: Mapping, key: str, path: str) -> np.ndarray:
        if tree is None or key not in tree:
            raise ValueError(f"flax variables have no leaf {path}/{key}")
        self.used.add(f"{path}/{key}")
        return np.asarray(tree[key])

    def put(self, tensor: torch.Tensor, value: np.ndarray, name: str):
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: flax shape {value.shape} != port "
                             f"shape {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.array(value)))
        self.filled.add(name)

    def fill(self, module: nn.Module, p: Optional[Mapping],
             s: Optional[Mapping], ppath: str, spath: str, name: str):
        def take_p(key):
            return self.take(p, key, ppath)

        if isinstance(module, nn.Linear):
            k = take_p("kernel").reshape(module.in_features,
                                         module.out_features)
            self.put(module.weight, k.T, f"{name}weight")
            if module.bias is not None:  # flax's Dense(use_bias=False)
                self.put(module.bias, take_p("bias").reshape(-1),
                         f"{name}bias")
            return
        if isinstance(module, nn.Conv1d):
            # flax (K, Cin, Cout) → torch (Cout, Cin, K)
            self.put(module.weight, take_p("kernel").transpose(2, 1, 0),
                     f"{name}weight")
            self.put(module.bias, take_p("bias"), f"{name}bias")
            return
        if isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
            self.put(module.weight, take_p("scale"), f"{name}weight")
            self.put(module.bias, take_p("bias"), f"{name}bias")
            if isinstance(module, nn.BatchNorm1d):
                self.put(module.running_mean, self.take(s, "mean", spath),
                         f"{name}running_mean")
                self.put(module.running_var, self.take(s, "var", spath),
                         f"{name}running_var")
            return
        for key, param in module.named_parameters(recurse=False):
            self.put(param, take_p(key), f"{name}{key}")
        for key, child in module.named_children():
            if not child.state_dict():  # dropout, pooling: nothing to fill
                continue
            self.fill(child, None if p is None else p.get(key),
                      None if s is None else s.get(key),
                      f"{ppath}/{key}", f"{spath}/{key}", f"{name}{key}.")


def load_flax_variables(module: nn.Module, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``module``'s parameters and buffers from flax ``params`` and
    ``batch_stats``; returns the module."""
    loader = _Loader()
    loader.fill(module, params, batch_stats, "params", "batch_stats", "")
    unused = (_leaves(params, "params")
              | _leaves(batch_stats or {}, "batch_stats")) - loader.used
    if unused:
        raise ValueError(f"flax leaves not used by the port: {sorted(unused)}")
    unfilled = {k for k in module.state_dict()
                if not k.endswith("num_batches_tracked")} - loader.filled
    if unfilled:
        raise ValueError(f"port tensors not filled: {sorted(unfilled)}")
    return module


def _flax_kernel(parent: Optional[nn.Module], key: str,
                 linear: nn.Linear) -> np.ndarray:
    """A ``Linear``'s weight as flax's kernel: (in, out), but for the
    multi-head projections, which flax keeps as ``DenseGeneral`` kernels
    (d, H, hd) for q/k/v and (H, hd, d) for the output."""
    kernel = linear.weight.detach().cpu().numpy().T
    if isinstance(parent, MultiHeadAttention):
        heads = (parent.num_heads, parent.head_dim)
        shape = ((*heads, kernel.shape[1]) if key == "out_proj"
                 else (kernel.shape[0], *heads))
        return kernel.reshape(shape)
    return kernel


def _flax_trees(module: nn.Module, parent: Optional[nn.Module] = None,
                key: str = "") -> Tuple[dict, dict]:
    """(params, batch_stats) of ``module`` in flax layout; the inverse of
    ``_Loader.fill``."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    if isinstance(module, nn.Linear):
        p = {"kernel": _flax_kernel(parent, key, module)}
        if module.bias is not None:
            p["bias"] = host(module.bias)
            if isinstance(parent, MultiHeadAttention) and key != "out_proj":
                p["bias"] = p["bias"].reshape(parent.num_heads,
                                              parent.head_dim)
        return p, {}
    if isinstance(module, nn.Conv1d):
        return {"kernel": host(module.weight).transpose(2, 1, 0),
                "bias": host(module.bias)}, {}
    if isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
        p = {"scale": host(module.weight), "bias": host(module.bias)}
        if isinstance(module, nn.BatchNorm1d):
            return p, {"mean": host(module.running_mean),
                       "var": host(module.running_var)}
        return p, {}
    p = {k: host(v) for k, v in module.named_parameters(recurse=False)}
    s = {}
    for name, child in module.named_children():
        if not child.state_dict():  # dropout, pooling: nothing to take
            continue
        cp, cs = _flax_trees(child, module, name)
        if cp:
            p[name] = cp
        if cs:
            s[name] = cs
    return p, s


def flax_variables_from_module(module: nn.Module) -> dict:
    """``{"params", "batch_stats"}`` of ``module`` as nested dicts of numpy
    arrays in flax layout, the inverse of ``load_flax_variables``: what the
    JAX counterpart's ``init`` would give for these weights, so that
    ``core.quantize.save_quantized`` writes the JAX package's payload."""
    params, stats = _flax_trees(module)
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
