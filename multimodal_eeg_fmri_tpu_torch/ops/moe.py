"""Mixture-of-Experts FFN (PyTorch): GShard's routing, moved by index.

Counterpart of ``multimodal_eeg_fmri_tpu/ops/moe.py``: top-k routing with a
static per-expert capacity. The JAX package expresses the routing as
``(tokens, experts, capacity)`` one-hot dispatch and combine tensors and
contracts them; the port computes the same function by index, in
O(S·k·D) instead of O(S·E·C·D). ``index_routing`` gives each (token,
choice) its expert, its place in that expert's queue, whether it is kept
and its gate; the dispatch gathers the kept tokens' rows into the (E, C, D)
expert buffer (an empty slot a row of zeros), the two expert GEMMs run on
that buffer, and the combine gathers each (token, choice)'s output row and
sums its k rows weighted by the gates. Each gather's gradient is the gather
by the inverse map followed by the sum over k (``gather_rows``): nothing
accumulates through atomics, so forward and backward are the same bits
when repeated. ``top_k_routing`` still returns the dense tensors, built
from ``index_routing``, for its callers and the parity tests; the layer
builds none. The router runs in f32 whatever the compute dtype (its weight
is upcast, as flax promotes a bf16 kernel against f32 inputs); the expert
products run in the input's dtype.

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
the expert axis replicates; the pairs routed to other ranks' experts take
no slot here) and sums the outputs over the axis. E that does not divide
the axis stays replicated, with one warning per shape.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch._C import _functorch

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


class Route(NamedTuple):
    """``index_routing``'s result: per (token, choice), each (S, k), best
    choice first, and the layer's aux loss."""

    expert: torch.Tensor    # int64, the chosen expert
    pos: torch.Tensor       # int64, its place in that expert's queue
    keep: torch.Tensor      # bool, pos < capacity
    gate: torch.Tensor      # f32, the gate (dropped pairs' too)
    aux: torch.Tensor       # (), the Switch loss on the first choices


def index_routing(router_logits: torch.Tensor, k: int, capacity: int,
                  shards: Optional[Tuple[int, list]] = None) -> Route:
    """Top-k token→expert assignment with a static per-expert capacity,
    by index.

    ``router_logits`` (S, E) f32. Each token's k best experts (ties to the
    lowest index, as ``jax.lax.top_k`` breaks them) queue choice-major:
    every first choice before any second choice, tokens in order within a
    choice, so that first choices win capacity over second choices; a
    (token, choice) at a place ≥ ``capacity`` is dropped. The gate is the
    raw router probability for k = 1 (the Switch gate), the top-k
    probabilities renormalised for k ≥ 2; ``aux`` the Switch loss on the
    first choices before capacity.

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

    if shards is None:
        # (E, k·S) one-hot, choice-major along its contiguous axis: the
        # exclusive scan runs along rows of k·S (whole numbers, exact in
        # f32), not down 4 columns of a (k·S, E) tensor
        order = top_i.t().reshape(1, k * S)
        flat = (order == torch.arange(E, device=order.device)[:, None]
                ).float()
        queue = torch.cumsum(flat, dim=1) - flat             # (E, k·S)
        pos = queue.gather(0, order).view(k, S).t().long()   # (S, k)
        f = flat[:, :S].mean(1)                              # (E,)
        p = probs.mean(0)                                    # (E,)
    else:
        choice = _one_hot(top_i, E)                          # (S, k, E)
        pos = (_queue_positions(choice, *shards) * choice).sum(-1).long()
        sums = torch.stack([choice[:, 0].sum(0), probs.sum(0)])
        n = S
        for mesh, a, _ in shards[1]:
            sums = psum(sums, a, mesh)
            n *= mesh.shape[a]
        f, p = sums[0] / n, sums[1] / n
    aux = E * (f * p).sum()
    return Route(top_i, pos, pos < capacity, gates, aux)


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int,
                  shards: Optional[Tuple[int, list]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``index_routing`` as the JAX package's dense tensors.

    Returns ``(dispatch, combine, aux)``: ``dispatch`` (S, E, C) 0/1,
    token s in slot c of expert e; ``combine`` the dispatch weighted by the
    gate; ``aux`` the Switch loss. ``MoEFFN`` moves its rows by index and
    builds neither."""
    route = index_routing(router_logits, k, capacity, shards)
    choice = _one_hot(route.expert, router_logits.shape[1])  # (S, k, E)
    slot = _one_hot(route.pos, capacity)                     # (S, k, C)
    keep = route.keep.float()
    # Σ_k choice·slot·w with the weight folded into ``choice``: no
    # (S, k, E, C) tensor; at most one k is nonzero for each (s, e, c)
    dispatch = torch.einsum("ske,skc->sec", choice * keep[..., None], slot)
    combine = torch.einsum("ske,skc->sec",
                           choice * (keep * route.gate)[..., None], slot)
    return dispatch, combine, route.aux


def slot_maps(route: Route, capacity: int, e0: int, held: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two maps between (token, choice) pairs and the slots of this
    rank's experts [e0, e0 + held), C = ``capacity`` slots each:
    ``slot`` (S·k,), the flat slot (e − e0)·C + pos of each pair, held·C
    (the sentinel) where the pair is dropped or its expert is another
    rank's; ``pair`` (held·C,), the pair s·k + j in each slot, S·k (the
    sentinel) where the slot is empty. Each kept pair has a slot of its
    own, so the map is built by assignment, not accumulation."""
    S, k = route.expert.shape
    n = held * capacity
    local = route.expert - e0
    mine = route.keep & (local >= 0) & (local < held)
    slot = torch.where(mine, local * capacity + route.pos, n).reshape(S * k)
    pairs = torch.arange(S * k, device=slot.device)
    # the sentinel's extra entry takes every unplaced pair and is cut off
    pair = torch.full((n + 1,), S * k, dtype=slot.dtype,
                      device=slot.device).scatter(0, slot, pairs)[:n]
    return slot, pair


def _gather_rows_plain(src: torch.Tensor, index: torch.Tensor
                       ) -> torch.Tensor:
    """Rows ``index`` of ``src`` (N, D), a row of zeros for index N."""
    return torch.nn.functional.pad(src, (0, 0, 0, 1)).index_select(0, index)


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with its gradient by the inverse map: no
    ``index_add_``, so no atomics."""

    generate_vmap_rule = True

    @staticmethod
    def forward(src, index, inverse):
        return _gather_rows_plain(src, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        rows = _gather_rows_plain(grad, inverse.reshape(-1))
        # Σ over the g readers of each row, in a fixed order
        return rows.view(*inverse.shape, -1).sum(1), None, None


def gather_rows(src: torch.Tensor, index: torch.Tensor,
                inverse: torch.Tensor) -> torch.Tensor:
    """(M, D) rows ``index`` (M,) of ``src`` (N, D), zeros where the index
    is N. ``inverse`` (N, g) lists the g output rows that read each row of
    ``src`` (M where fewer do): the gradient of ``src`` is the output's
    gradient gathered by it and summed over g in a fixed order, so it is
    the same bits on every run. Where no gradient is wanted it is the plain
    gather (so that ``torch.export`` traces plain ATen ops)."""
    # a vmapped tensor does not show whether the tensor it wraps needs grad
    if torch.is_grad_enabled() and (
            src.requires_grad or _functorch.is_functorch_wrapped_tensor(src)):
        return _GatherRows.apply(src, index, inverse)
    return _gather_rows_plain(src, index)


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

    def _routed_tokens(self, x: torch.Tensor):
        """(shards, tokens of the whole batch) of ``x`` (B, T, D)."""
        shards = self._shards(x.shape[0])
        total = x.shape[0] * x.shape[1]
        for mesh, a, _ in (shards[1] if shards else ()):
            total *= mesh.shape[a]
        return shards, total

    def routing(self, x: torch.Tensor) -> Route:
        """``index_routing`` of the tokens of ``x`` (B, T, D), on the f32
        router, over the whole batch where the tokens are sharded."""
        S = x.shape[0] * x.shape[1]
        shards, total = self._routed_tokens(x)
        logits = torch.nn.functional.linear(
            x.reshape(S, -1).float(), self.router.weight.float())
        return index_routing(logits, min(self.top_k, self.num_experts),
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
        return self._forward_held(x, *self._local_experts())

    def _forward_held(self, x: torch.Tensor, e0: int, held: int
                      ) -> torch.Tensor:
        """The layer on ``x`` (B, T, D) where this rank's ``w1`` … ``b2``
        hold experts [e0, e0 + held): route every token, move the pairs
        routed to those experts by index, and with held < E sum the
        outputs over the expert axis."""
        B, T, D = x.shape
        S = B * T
        with annotate("mmef/moe/route"):
            route = self.routing(x)
        if self.training:
            add_aux_loss(self.aux_weight * route.aux)
        dt = x.dtype
        k = route.expert.shape[1]
        C = self.capacity(self._routed_tokens(x)[1])
        with annotate("mmef/moe/dispatch"):
            slot, pair = slot_maps(route, C, e0, held)
            # each slot's token (an empty slot's S·k → S, a row of zeros);
            # each token's rows are its k pairs' slots
            xe = gather_rows(x.reshape(S, D), pair // k,
                             slot.view(S, k)).view(held, C, D)
        with annotate("mmef/moe/experts"):
            h = gelu(torch.einsum("ecd,edf->ecf", xe, self.w1)
                      + self.b1[:, None, :])
            ye = (torch.einsum("ecf,efd->ecd", h, self.w2)
                  + self.b2[:, None, :])
        with annotate("mmef/moe/combine"):
            yk = gather_rows(ye.reshape(held * C, D), slot,
                             pair.view(held * C, 1)).view(S, k, D)
            # the gates rounded to the compute dtype, as the JAX package's
            # combine rounds them; the k products summed in f32
            w = (route.keep * route.gate).to(dt)
            y = (w.float()[..., None] * yk.float()).sum(1).to(dt)
            if held < self.num_experts:
                y = psum(y, self.expert_axis, self.mesh)
        return y.reshape(B, T, D)
