"""Plain PyTorch pieces the references share: the layer equations, the
losses, global-norm clipping, AdamW, z-scoring and the temporal
augmentation. Nothing here imports the port, JAX or the JAX package; each
is written from its equation.

Random draws. Where the program draws (dropout, the augmentation), the
reference draws again from generators seeded alike, with calls of the same
shapes, layouts and order, so that both sides draw the same numbers: the
benchmark seeds the two generators, and the reference works the masks out
again rather than taking the program's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, 0.5·x·(1 + erf(x/√2))."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x − max) / Σ exp(x − max), in the layout of x."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def dense(p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
    """x·Wᵀ + b with W (out, in)."""
    y = F.linear(x, p[f"{name}.weight"])
    bias = p.get(f"{name}.bias")
    return y if bias is None else y + bias


def layer_norm(p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-5)


def batch_norm(p: Tensors, name: str, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    """BatchNorm over every axis but 1 (the features), ε = 1e-5: the
    batch's mean and biased variance in training, the running statistics
    in evaluation."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    w, b = p[f"{name}.weight"].view(shape), p[f"{name}.bias"].view(shape)
    if train:
        axes = [0, *range(2, x.dim())]
        mean = x.mean(axes, keepdim=True)
        var = ((x - mean) ** 2).mean(axes, keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].view(shape)
        var = p[f"{name}.running_var"].view(shape)
    return (x - mean) / torch.sqrt(var + 1e-5) * w + b


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    return F.dropout(x, rate, train)


def position_table(length: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table: sin at even columns, cos at odd, of
    pos / 10000^(2i/d), worked out in float64 and rounded to float32."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(0, d, 2, dtype=torch.float64, device=device)
    angle = pos / torch.pow(torch.tensor(10000.0, dtype=torch.float64,
                                         device=device), i / d)
    table = torch.zeros(length, d, dtype=torch.float64, device=device)
    table[:, 0::2] = torch.sin(angle)
    table[:, 1::2] = torch.cos(angle)[:, : d // 2]
    return table.float()


def attention(p: Tensors, name: str, query, key, value, heads: int,
              rate: float, train: bool) -> torch.Tensor:
    """Multi-head attention, every score computed: softmax(q·kᵀ/√d)·v over
    (B, T, H, d) projections, dropout on the probabilities, then the
    output projection."""
    B, Tq, width = query.shape
    d = width // heads
    q = dense(p, f"{name}.q_proj", query).view(B, Tq, heads, d)
    k = dense(p, f"{name}.k_proj", key).view(B, key.shape[1], heads, d)
    v = dense(p, f"{name}.v_proj", value).view(B, value.shape[1], heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    probs = dropout(softmax(scores), rate, train)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return dense(p, f"{name}.out_proj", out.reshape(B, Tq, width))


def zscore(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x − mean) / (population std + eps) over each sample's (T, C)."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    sd = ((x - mu) ** 2).mean(dim=(1, 2), keepdim=True).sqrt()
    return (x - mu) / (sd + eps)


def augment_temporal(gen: torch.Generator, x: torch.Tensor,
                     noise_std: float = 0.05, channel_drop: float = 0.1,
                     prob: float = 0.3) -> torch.Tensor:
    """Per sample with probability ``prob``: add noise at ``noise_std`` of
    the sample's std; then per sample with probability ``prob``: zero each
    channel with probability ``channel_drop``. Draws, in order: the noise
    (B, T, C), the first gate (B,), the channel mask (B, C), the second
    gate (B,)."""
    B, T, C = x.shape
    std = ((x - x.mean(dim=(1, 2), keepdim=True)) ** 2).mean(
        dim=(1, 2), keepdim=True).sqrt()
    noise = torch.randn(x.shape, generator=gen, device=x.device,
                        dtype=x.dtype) * (noise_std * std)
    gate1 = torch.rand((B, 1, 1), generator=gen, device=x.device) < prob
    x = torch.where(gate1, x + noise, x)
    keep = (torch.rand((B, 1, C), generator=gen, device=x.device)
            < 1.0 - channel_drop).to(x.dtype)
    gate2 = torch.rand((B, 1, 1), generator=gen, device=x.device) < prob
    return torch.where(gate2, x * keep, x)


def cross_entropy(logits, labels, class_weights=None, sample_weights=None):
    """Σ w·(−log softmax(logits)[label]) / max(Σ w, 1e-8), w the class
    weight of the label times the sample weight (1 without either)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp[torch.arange(len(labels), device=labels.device),
                labels.long()]
    w = torch.ones_like(nll)
    if class_weights is not None:
        w = w * class_weights.float()[labels.long()]
    if sample_weights is not None:
        w = w * sample_weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1e-8)


def clip_global(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm/‖g‖ where the global norm ‖g‖
    reaches max_norm (no epsilon); returns ‖g‖."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    for g in grads:
        g.mul_(scale)
    return norm


class AdamW:
    """Adam (β1, β2, ε) with decoupled weight decay: p ← p·(1 − lr·wd),
    then p ← p − lr·m̂/(√v̂ + ε), m̂ and v̂ bias-corrected."""

    def __init__(self, params: List[torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, wd
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.mul_(1.0 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_steps(forward: Callable, params0: Tensors, batches: List[dict],
                hyper: dict, seeds: dict, device) -> dict:
    """Follow the program's first steps from the same weights, batches and
    seeds: per step the augmentation (z-score then ``augment_temporal`` of
    each key in ``hyper["augment"]``, in order, from one generator), the
    train-mode forward (``forward(params, inputs) -> (logits, aux)``), the
    loss plus the aux losses, the gradients, global-norm clipping and
    AdamW. Returns each step's loss, the first step's logits and clipped
    gradient, and the parameters after the last step, by name."""
    names = list(params0)
    params = [params0[n].detach().clone().requires_grad_(True)
              for n in names]
    opt = AdamW(params, hyper["lr"], hyper["wd"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds["augment"])
    torch.manual_seed(seeds["dropout"])
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seeds["dropout"])
    cw = hyper.get("class_weights")
    losses, grad1, logits1 = [], None, None
    for batch in batches:
        inputs = {k: v for k, v in batch.items()
                  if k not in ("label", "weight")}
        for key in hyper.get("augment", ()):
            inputs[key] = augment_temporal(gen, zscore(inputs[key]))
        p = dict(zip(names, params))
        logits, aux = forward(p, inputs)
        if logits1 is None:
            logits1 = logits.detach().clone()
        loss = cross_entropy(logits, batch["label"], cw,
                             batch.get("weight"))
        if aux is not None:
            loss = loss + aux
        grads = list(torch.autograd.grad(loss, params, allow_unused=True))
        grads = [torch.zeros_like(q) if g is None else g
                 for g, q in zip(grads, params)]
        clip_global(grads, hyper["clip"])
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "logits1": logits1, "grad1": grad1,
            "params": {n: q.detach().clone() for n, q in zip(names, params)}}
