"""Operations and bytes that work needs, counted from shapes, and the
card's peaks. Two operations per multiply-add; elementwise work, exp and
norms are not counted. Nothing here reads the program: a change that
removes wasted work moves the measured time and leaves these counts as
they are.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
PEAK_FLOPS = PEAKS["f32_accurate_flops"]
PEAK_BYTES = PEAKS["bytes_per_s"]
PEAK_BF16_FLOPS = PEAKS["bf16_flops"]
PEAK_MIXED_FLOPS = max(PEAKS["tf32_flops"] / 2, PEAK_BF16_FLOPS / 3)


def dense(rows: float, fan_in: int, fan_out: int) -> float:
    return 2.0 * rows * fan_in * fan_out


def conv1d(batch: int, length: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * batch * length * c_in * c_out * k


def attention_core(batch: int, heads: int, tq: int, tk: int, d: int) -> float:
    """Q·Kᵀ and P·V, every score."""
    return 4.0 * batch * heads * tq * tk * d


def mha_forward(batch: int, tq: int, tk: int, width: int,
                heads: int) -> float:
    """A multi-head attention layer's forward: the four projections and
    the core."""
    return (dense(batch * tq, width, width) * 2          # q, out
            + dense(batch * tk, width, width) * 2        # k, v
            + attention_core(batch, heads, tq, tk, width // heads))


def mha_work(batch: int, tq: int, tk: int, width: int, heads: int,
             self_attention: bool, backward: bool,
             size: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of an attention layer's call as its span holds
    it: the forward, or the forward and the backward (twice the forward's
    products, nothing recomputed). Each input byte read once and each
    output byte written once: the forward reads its inputs and the four
    weights and writes its output; the backward reads the inputs, the
    output's gradient and the weights and writes the inputs' gradients and
    the weights'."""
    flops = mha_forward(batch, tq, tk, width, heads)
    inputs = batch * tq * width if self_attention else (
        batch * tq * width + 2 * batch * tk * width)
    weights = 4 * width * width + 4 * width
    out = batch * tq * width
    moved = inputs + weights + out
    if backward:
        flops *= 3.0
        moved += (inputs + out + weights) + (inputs + weights)
    return flops, size * moved


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time of the work on the card: operations over the
    f32-accurate peak, or bytes over the memory rate, the larger."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def kernel_bound_ms(kernel: str, B: int, H: int, tq: int, tk: int, d: int,
                    storage: str = "f32") -> Tuple[float, str]:
    """Least time (ms) of one flash kernel's work, f32-accurate, and what
    bounds it: operations (2 per multiply-add, exp not counted) over the
    peak rate for their operands' type, whatever route the kernel takes,
    or bytes (each input read once, each output written once) over the
    memory rate. K1 (``flash_fwd``) makes two products, K2
    (``flash_bwd_dkv``) four and K3 (``flash_bwd_dq``) three, as the
    kernels compute them (the backward kernels recompute the scores). With
    f32 storage every product runs at the 3xTF32 rate; with bf16 storage
    the products of two stored tensors are exact at the bf16 rate and those
    of an f32 operand at the mixed rate; stored tensors take 2 bytes, lse
    and Δ 4. (A copy of ``chip_smoke.py:bound_ms``.)"""
    bh = B * H
    q_el, k_el = bh * tq * d, bh * tk * d
    products = bh * tq * tk * d * 2
    stored, mixed = {"flash_fwd": (1, 1), "flash_bwd_dkv": (2, 2),
                     "flash_bwd_dq": (2, 1)}[kernel]
    if storage == "f32":
        stored, mixed = 0, stored + mixed
    t_ops = products * (stored / PEAK_BF16_FLOPS + mixed / (
        PEAK_FLOPS if storage == "f32" else PEAK_MIXED_FLOPS))
    size = 4 if storage == "f32" else 2
    elems, stats = {
        "flash_fwd": (2 * q_el + 2 * k_el, bh * tq),
        "flash_bwd_dkv": (2 * q_el + 4 * k_el, 2 * bh * tq),
        "flash_bwd_dq": (3 * q_el + 2 * k_el, 2 * bh * tq)}[kernel]
    t_bytes = (size * elems + 4 * stats) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
