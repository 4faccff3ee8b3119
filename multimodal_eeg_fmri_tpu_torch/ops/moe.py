"""Mixture-of-Experts FFN (PyTorch), the dense GShard formulation.

Counterpart of ``multimodal_eeg_fmri_tpu/ops/moe.py``: top-k routing with a
static per-expert capacity, expressed as ``(tokens, experts, capacity)``
dispatch and combine tensors, so that the layer is plain products: the
dispatch, the two expert GEMMs and the combine, with no gather, no scatter
and no data-dependent shape. The router runs in f32 whatever the compute
dtype (its weight is upcast, as flax promotes a bf16 kernel against f32
inputs); the expert products run in the input's dtype.

The Switch load-balance loss ``E · Σ_e f_e · p_e`` of each layer in
training mode goes, scaled by ``aux_weight``, to the innermost open
``collect_aux_losses()``; ``train.fit.TrainStep`` opens one around its
forward and adds the sum to the task loss, as the JAX package's ``fit``
adds its sown "losses" collection. Eval forwards leave nothing.

Expert parallelism (``mesh`` / ``expert_axis``) is not ported yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn

# where the MoE layers of a training forward leave their scaled aux losses:
# the list of the innermost open ``collect_aux_losses()``, or None
_AUX_SINK: contextvars.ContextVar[Optional[List[torch.Tensor]]] = (
    contextvars.ContextVar("moe_aux_sink", default=None))


@contextlib.contextmanager
def collect_aux_losses() -> Iterator[List[torch.Tensor]]:
    """Collect the scaled aux losses of the MoE layers run in training mode
    inside the block: yields the list they are appended to. Nested blocks
    collect apart; a backward's recomputation (``torch.utils.checkpoint``)
    runs outside the block and adds nothing to it."""
    sink: List[torch.Tensor] = []
    token = _AUX_SINK.set(sink)
    try:
        yield sink
    finally:
        _AUX_SINK.reset(token)


def add_aux_loss(aux: Optional[torch.Tensor]) -> None:
    """Hand ``aux`` to the innermost open ``collect_aux_losses()``, if any."""
    sink = _AUX_SINK.get()
    if sink is not None and aux is not None:
        sink.append(aux)


def total_aux_loss(sink: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """Σ of the collected aux losses in f32, or None if there are none."""
    if not sink:
        return None
    return torch.stack(sink).sum()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` computes it (the
    port's ``models.layers.gelu``, defined here so that ops/ never imports
    models/)."""
    sqrt_half = torch.tensor(math.sqrt(0.5)).to(x.dtype).item()
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over the last axis, from a comparison with ``arange``
    (which ``torch.func.vmap`` batches)."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def top_k_choices(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k probabilities, their expert indices), each (S, k), best
    first; ties go to the lowest expert index, as ``jax.lax.top_k`` breaks
    them (a stable descending sort keeps tied experts in index order;
    ``torch.topk`` promises no order)."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_i[:, :k]


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token→expert assignment with a static per-expert capacity.

    ``router_logits`` (S, E) f32. Returns ``(dispatch, combine, aux)``:
    ``dispatch`` (S, E, C) 0/1, token s in slot c of expert e, first
    choices placed before any second choice and tokens past an expert's
    capacity dropped; ``combine`` the dispatch weighted by the gate (k = 1:
    the raw router probability, the Switch gate; k ≥ 2: the top-k
    probabilities renormalised); ``aux`` the Switch loss on the first
    choices before capacity. Ties go to the lowest expert index, as
    ``jax.lax.top_k`` breaks them."""
    S, E = router_logits.shape
    e = torch.exp(router_logits
                  - router_logits.amax(-1, keepdim=True).detach())
    probs = e / e.sum(-1, keepdim=True)                      # (S, E)
    top_p, top_i = top_k_choices(probs, k)                  # (S, k)
    gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True)

    choice = _one_hot(top_i, E)                              # (S, k, E)
    # each (token, choice)'s place in its expert's queue, choice-major, so
    # that first choices win capacity over second choices
    flat = choice.transpose(0, 1).reshape(k * S, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat              # (k·S, E)
    pos = (pos_flat.reshape(k, S, E).transpose(0, 1)
           * choice).sum(-1).long()                          # (S, k)
    keep = (pos < capacity).float()                          # (S, k)
    slot = _one_hot(pos, capacity)                           # (S, k, C)
    # Σ_k choice·slot·w with the weight folded into ``choice``: no
    # (S, k, E, C) tensor; at most one k is nonzero for each (s, e, c)
    dispatch = torch.einsum("ske,skc->sec", choice * keep[..., None], slot)
    combine = torch.einsum("ske,skc->sec",
                           choice * (keep * gates)[..., None], slot)

    f = choice[:, 0, :].mean(0)                              # (E,)
    p = probs.mean(0)                                        # (E,)
    aux = E * (f * p).sum()
    return dispatch, combine, aux


class MoEFFN(nn.Module):
    """Drop-in MoE replacement for the transformer FFN: a bias-less f32
    router (``router``, flax's ``Dense(E, use_bias=False)``) and ``E``
    GELU experts whose weights keep flax's layout, ``w1`` (E, D, ff),
    ``b1`` (E, ff), ``w2`` (E, ff, D), ``b2`` (E, D)."""

    def __init__(self, d_model: int, num_experts: int,
                 dim_feedforward: int = 0, top_k: int = 1,
                 capacity_factor: float = 2.0, aux_weight: float = 0.01,
                 mesh=None, expert_axis: Optional[str] = None, device=None):
        super().__init__()
        if mesh is not None or expert_axis is not None:
            raise NotImplementedError(
                "MoEFFN's expert parallelism (mesh / expert_axis) is not "
                "ported yet (ROADMAP.md, queue A item 7b: parameter "
                "sharding)")
        E, ff = num_experts, dim_feedforward or 4 * d_model
        self.num_experts = E
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.router = nn.Linear(d_model, E, bias=False, device=device)
        # torch's Linear default, U(±1/√fan_in) over D·E as flax counts the
        # expert axis (convert.init_weights draws flax's lecun-normal)
        self.w1 = nn.Parameter(torch.empty(E, d_model, ff, device=device))
        self.b1 = nn.Parameter(torch.zeros(E, ff, device=device))
        self.w2 = nn.Parameter(torch.empty(E, ff, d_model, device=device))
        self.b2 = nn.Parameter(torch.zeros(E, d_model, device=device))
        for w in (self.w1, self.w2):
            bound = 1.0 / math.sqrt(w.shape[0] * w.shape[1])
            nn.init.uniform_(w, -bound, bound)

    def capacity(self, tokens: int) -> int:
        """Slots per expert: ceil(S·cf/E), at least 1 and at most S (the
        JAX package's formula, float floor division and all)."""
        capacity = max(1, int(-(-tokens * self.capacity_factor
                                // self.num_experts)))
        return min(capacity, tokens)

    def routing(self, x: torch.Tensor):
        """``top_k_routing`` of the tokens of ``x`` (B, T, D), on the f32
        router."""
        S = x.shape[0] * x.shape[1]
        logits = torch.nn.functional.linear(
            x.reshape(S, -1).float(), self.router.weight.float())
        return top_k_routing(logits, min(self.top_k, self.num_experts),
                             self.capacity(S))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        dispatch, combine, aux = self.routing(x)
        if self.training:
            add_aux_loss(self.aux_weight * aux)
        dt = x.dtype
        xs = x.reshape(B * T, D)
        xe = torch.einsum("sec,sd->ecd", dispatch.to(dt), xs)   # (E, C, D)
        h = _gelu(torch.einsum("ecd,edf->ecf", xe, self.w1)
                  + self.b1[:, None, :])
        ye = torch.einsum("ecf,efd->ecd", h, self.w2) + self.b2[:, None, :]
        # combine rounds its gates to the compute dtype, as the JAX
        # package's does
        y = torch.einsum("sec,ecd->sd", combine.to(dt), ye)
        return y.reshape(B, T, D)
