"""Weights from the seed, made on the device in one draw.

Every weight matrix or kernel (a parameter of two or more axes that is not
a bias) takes normal values over the square root of its fan-in, cut from
one ``torch.randn`` of all of them together on the device; biases start at
zero; the other parameters (norm scales, fusion logits, temperatures) keep
the constant values their constructors give them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    """The inputs of one output of a weight: (out, in) linear weights and
    (E, in, out) expert weights take in, (out, in, k) convolution weights
    in·k, and (k, in, out) convolution kernels k·in."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 2:
        return shape[1]
    if leaf == "weight":
        return shape[1] * shape[2]
    if leaf == "kernel":
        return shape[0] * shape[1]
    return shape[1]


def is_bias(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "bias" or (leaf.startswith("b") and leaf[1:].isdigit())


def drawn(named: List[Tuple[str, torch.Tensor]]) -> List[Tuple[str, torch.Tensor]]:
    return [(n, p) for n, p in named if p.dim() >= 2 and not is_bias(n)]


@torch.no_grad()
def init_from_seed(model: torch.nn.Module, generator: torch.Generator,
                   members: int = 0) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s weights from ``generator`` (one draw) and zero its
    biases; with ``members`` > 0 leave the model as it is and return
    (members, ...) stacked weights for that many members instead, from one
    draw, the other parameters repeated."""
    named = list(model.named_parameters())
    weights = drawn(named)
    k = max(members, 1)
    total = k * sum(p.numel() for _, p in weights)
    device = named[0][1].device
    flat = torch.randn(total, generator=generator, device=device)
    out, offset = {}, 0
    for n, p in weights:
        size = k * p.numel()
        block = flat[offset:offset + size].view(k, *p.shape)
        out[n] = block / math.sqrt(fan_in(n, tuple(p.shape)))
        offset += size
    for n, p in named:
        if n not in out:
            base = torch.zeros_like(p) if is_bias(n) else p.detach()
            out[n] = base[None].expand(k, *p.shape).clone()
    if members:
        return {n: out[n] for n, _ in named}
    for n, p in named:
        p.copy_(out[n][0])
    return {n: p.detach() for n, p in named}
