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

Sharded tokens and experts. The JAX package routes the tokens of the whole
batch (under GSPMD a batch sharded over ``data``, or a sequence over a
ring's ``seq`` axis, is still one array): the capacity ``ceil(S·cf/E)``,
the choice-major queue positions and the aux loss's means all run over
every token. The port's ranks each hold their rows (inside
``parallel.mesh.batch_sharded``) and their time slice (``seq_axis``), so a
rank gathers every rank's per-row, per-expert counts and places its tokens
in the queues from the counts before them, in the global (B, T) row-major
order (on a ring the seq ranks interleave row by row). With ``expert_axis``
each rank holds E/n experts (``parallel.expert`` shards ``w1``, ``b1``,
``w2``, ``b2``), computes its experts' outputs for its own tokens (which
the expert axis replicates) and sums the outputs over the axis. E that does
not divide the axis stays replicated, with one warning per shape.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core.profiling import annotate
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    all_gather,
    psum,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import current_batch_axis

logger = logging.getLogger(__name__)

# (E, axis, size) of the expert layers that fell back to replicated experts
_REPLICATION_WARNED: set = set()

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


def gelu(x: torch.Tensor) -> torch.Tensor:
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


def _queue_positions(choice: torch.Tensor, rows: int,
                     axes: List[tuple]) -> torch.Tensor:
    """(S, k, E) exclusive queue positions of each (token, choice) in each
    expert's queue, choice-major over the global (B, T) row-major order.
    ``choice`` is this rank's (S, k, E) one-hot, S = rows · T_local in
    row-major order; ``axes`` the (mesh, axis, "rows" | "time") its tokens
    shard over: rows over the data axis, time over the seq axis."""
    S, k, E = choice.shape
    c = choice.view(rows, S // rows, k, E)
    # exclusive cumsum over the local time slice of each row
    local = torch.cumsum(c, dim=1) - c
    counts = c.sum(1)                                   # (rows, k, E)
    seq = [(m, a) for m, a, kind in axes if kind == "time"]
    data = [(m, a) for m, a, kind in axes if kind == "rows"]
    # every seq rank's counts of this rank's rows: (n_seq, rows, k, E)
    by_seq = counts[None]
    before_in_row = torch.zeros_like(counts)
    for mesh, a in seq:
        by_seq = all_gather(by_seq, a, axis=0, mesh=mesh)
        before_in_row = by_seq[:mesh.axis_index(a)].sum(0)
    row_total = by_seq.sum(0)                           # (rows, k, E)
    # every data rank's row totals: (n_data · rows, k, E)
    all_rows = row_total
    first = 0
    for mesh, a in data:
        all_rows = all_gather(row_total, a, axis=0, mesh=mesh)
        first = mesh.axis_index(a) * rows
    before_rows = (torch.cumsum(all_rows, 0) - all_rows)[first:first + rows]
    totals = all_rows.sum(0)                            # (k, E)
    before_choices = torch.cumsum(totals, 0) - totals   # (k, E)
    offset = before_choices[None] + before_rows + before_in_row
    return (local + offset[:, None]).view(S, k, E)


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int,
                  shards: Optional[Tuple[int, list]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token→expert assignment with a static per-expert capacity.

    ``router_logits`` (S, E) f32. Returns ``(dispatch, combine, aux)``:
    ``dispatch`` (S, E, C) 0/1, token s in slot c of expert e, first
    choices placed before any second choice and tokens past an expert's
    capacity dropped; ``combine`` the dispatch weighted by the gate (k = 1:
    the raw router probability, the Switch gate; k ≥ 2: the top-k
    probabilities renormalised); ``aux`` the Switch loss on the first
    choices before capacity. Ties go to the lowest expert index, as
    ``jax.lax.top_k`` breaks them.

    ``shards`` = (rows, [(mesh, axis, "rows" | "time"), ...]): the logits
    are this rank's tokens of a batch sharded over those axes (rows rows of
    it here), and the queues and the aux loss's means are the whole
    batch's."""
    S, E = router_logits.shape
    e = torch.exp(router_logits
                  - router_logits.amax(-1, keepdim=True).detach())
    probs = e / e.sum(-1, keepdim=True)                      # (S, E)
    top_p, top_i = top_k_choices(probs, k)                  # (S, k)
    gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True)

    choice = _one_hot(top_i, E)                              # (S, k, E)
    if shards is None:
        # each (token, choice)'s place in its expert's queue, choice-major,
        # so that first choices win capacity over second choices
        flat = choice.transpose(0, 1).reshape(k * S, E)
        pos_flat = torch.cumsum(flat, dim=0) - flat          # (k·S, E)
        pos_e = pos_flat.reshape(k, S, E).transpose(0, 1)
    else:
        pos_e = _queue_positions(choice, *shards)
    pos = (pos_e * choice).sum(-1).long()                    # (S, k)
    keep = (pos < capacity).float()                          # (S, k)
    slot = _one_hot(pos, capacity)                           # (S, k, C)
    # Σ_k choice·slot·w with the weight folded into ``choice``: no
    # (S, k, E, C) tensor; at most one k is nonzero for each (s, e, c)
    dispatch = torch.einsum("ske,skc->sec", choice * keep[..., None], slot)
    combine = torch.einsum("ske,skc->sec",
                           choice * (keep * gates)[..., None], slot)

    if shards is None:
        f = choice[:, 0, :].mean(0)                          # (E,)
        p = probs.mean(0)                                    # (E,)
    else:
        sums = torch.stack([choice[:, 0, :].sum(0), probs.sum(0)])
        n = S
        for mesh, a, _ in shards[1]:
            sums = psum(sums, a, mesh)
            n *= mesh.shape[a]
        f, p = sums[0] / n, sums[1] / n
    aux = E * (f * p).sum()
    return dispatch, combine, aux


class MoEFFN(nn.Module):
    """Drop-in MoE replacement for the transformer FFN: a bias-less f32
    router (``router``, flax's ``Dense(E, use_bias=False)``) and ``E``
    GELU experts whose weights keep flax's layout, ``w1`` (E, D, ff),
    ``b1`` (E, ff), ``w2`` (E, ff, D), ``b2`` (E, D).

    ``mesh`` / ``expert_axis``: expert parallelism once ``parallel.expert``
    has sharded the experts (until then, or where E does not divide the
    axis, every rank runs all of them). ``seq_axis``: the tokens' time axis
    is sharded over that axis of ``mesh`` (the ring route)."""

    # the router's weight is read here, not through its forward
    _reads_child_params = ("router",)

    def __init__(self, d_model: int, num_experts: int,
                 dim_feedforward: int = 0, top_k: int = 1,
                 capacity_factor: float = 2.0, aux_weight: float = 0.01,
                 mesh=None, expert_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None, device=None):
        super().__init__()
        if expert_axis is not None and mesh is None:
            raise ValueError("MoEFFN: expert_axis needs a mesh")
        E, ff = num_experts, dim_feedforward or 4 * d_model
        self.num_experts = E
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.mesh = mesh
        self.expert_axis = expert_axis
        self.seq_axis = seq_axis
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

    def _shards(self, rows: int):
        """(rows, [(mesh, axis, kind)]) of the axes this layer's tokens
        shard over, or None."""
        axes = []
        batch = current_batch_axis()
        if batch is not None:
            axes.append((*batch, "rows"))
        if self.seq_axis is not None and self.mesh is not None:
            axes.append((self.mesh, self.seq_axis, "time"))
        return (rows, axes) if axes else None

    def routing(self, x: torch.Tensor):
        """``top_k_routing`` of the tokens of ``x`` (B, T, D), on the f32
        router, over the whole batch where the tokens are sharded."""
        S = x.shape[0] * x.shape[1]
        shards = self._shards(x.shape[0])
        total = S
        for mesh, a, _ in (shards[1] if shards else ()):
            total *= mesh.shape[a]
        logits = torch.nn.functional.linear(
            x.reshape(S, -1).float(), self.router.weight.float())
        return top_k_routing(logits, min(self.top_k, self.num_experts),
                             self.capacity(total), shards)

    def _local_experts(self) -> Tuple[int, int]:
        """(first expert, count) of the experts this rank holds."""
        held = self.w1.shape[0]
        if self.expert_axis is None:
            return 0, held
        n = self.mesh.shape[self.expert_axis]
        if self.num_experts % n:
            key = (self.num_experts, self.expert_axis, n)
            if key not in _REPLICATION_WARNED:
                _REPLICATION_WARNED.add(key)
                logger.warning(
                    "MoEFFN: %d experts do not divide mesh axis %r (size "
                    "%d) — falling back to REPLICATED expert weights. Pick "
                    "num_experts as a multiple of the expert-axis size to "
                    "shard.", self.num_experts, self.expert_axis, n)
        if held == self.num_experts:
            return 0, held
        return self.mesh.axis_index(self.expert_axis) * held, held

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        with annotate("mmef/moe/route"):
            dispatch, combine, aux = self.routing(x)
        if self.training:
            add_aux_loss(self.aux_weight * aux)
        dt = x.dtype
        e0, held = self._local_experts()
        if held < self.num_experts:
            dispatch = dispatch[:, e0:e0 + held]
            combine = combine[:, e0:e0 + held]
        xs = x.reshape(B * T, D)
        with annotate("mmef/moe/dispatch"):
            xe = torch.einsum("sec,sd->ecd", dispatch.to(dt), xs)  # (E, C, D)
        with annotate("mmef/moe/experts"):
            h = gelu(torch.einsum("ecd,edf->ecf", xe, self.w1)
                      + self.b1[:, None, :])
            ye = (torch.einsum("ecf,efd->ecd", h, self.w2)
                  + self.b2[:, None, :])
        with annotate("mmef/moe/combine"):
            # combine rounds its gates to the compute dtype, as the JAX
            # package's does
            y = torch.einsum("sec,ecd->sd", combine.to(dt), ye)
            if held < self.num_experts:
                y = psum(y, self.expert_axis, self.mesh)
        return y.reshape(B, T, D)
