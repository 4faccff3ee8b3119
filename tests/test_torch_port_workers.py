"""Rank bodies of the port's parallel tests (no test of its own), run by
``parallel.distributed.spawn_local_world`` in spawned processes. This module
imports the port and never JAX, so that its workers do not either: each
returns ``"jax" in sys.modules`` beside its results, and the tests check it.

Arrays go in as numpy (the tests' seeded inputs) and come out as tensors or
numpy; a rank's results are its own shards, which the tests reassemble.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch import load_flax_variables, make_fit_fn
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
from multimodal_eeg_fmri_tpu_torch.ops.ring_attention import ring_attention
from multimodal_eeg_fmri_tpu_torch.parallel import (
    Mesh,
    all_gather,
    build_mesh,
    pmean,
    pmean_grads,
    ppermute_shift,
    psum,
    shard_sequence,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(shape, names) -> Mesh:
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def ring_attention_cases(rank, world, cases):
    """Each case: (mesh shape, axis names, seq axis, head axis, impl,
    compute dtype name, q, k, v, g). Returns per case this rank's output
    block and the gradients of sum(out * g) in q, k and v; then the
    refusals' messages (``ring_refusals``)."""
    out = []
    for shape, names, seq, heads, impl, cdt, *arrays in cases:
        mesh = _mesh(shape, names)
        q, k, v, g = (torch.from_numpy(shard_sequence(a, mesh, seq, heads))
                      for a in arrays)
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        o = ring_attention(q, k, v, mesh, axis=seq, head_axis=heads,
                           compute_dtype=DTYPES[cdt], impl=impl)
        (o * g).sum().backward()
        out.append((o.detach(), q.grad, k.grad, v.grad))
    return out, ring_refusals(world), "jax" in sys.modules


def ring_refusals(world):
    """The ring's refusals' messages on a ring of the whole world: a
    custom scale on the flash chunk, a T that does not divide the ring, a
    ring size other than the axis's (None where nothing was raised)."""
    from multimodal_eeg_fmri_tpu_torch.ops.ring_attention import (
        ring_attention_local,
    )

    mesh = _mesh((world,), ("data",))
    x = torch.zeros(1, 1, 4, 8)
    got = []
    for fn in (
            lambda: ring_attention_local(x, x, x, "data", world, scale=0.5,
                                         impl="flash", mesh=mesh),
            lambda: shard_sequence(np.zeros((1, 1, 31, 8)), mesh, "data"),
            lambda: ring_attention_local(x, x, x, "data", world + 1,
                                         mesh=mesh)):
        try:
            fn()
            got.append(None)
        except ValueError as e:
            got.append(str(e))
    return got


def collectives(rank, world, x):
    """The collectives on a (4, 2) ("ensemble", "data") mesh and their
    gradients: x is (8, 3), row r this rank's value. Returns each result
    and the gradient of sum(result * w) with w = arange."""
    plan = build_mesh(ensemble=4, data=2)
    mesh = plan.mesh
    mine = torch.from_numpy(x[rank]).requires_grad_()
    results = {}
    with mesh:
        for name, fn in (
                ("psum_data", lambda t: psum(t, "data")),
                ("psum_all", lambda t: psum(t, ("ensemble", "data"))),
                ("pmean_ensemble", lambda t: pmean(t, "ensemble")),
                ("all_gather_ensemble",
                 lambda t: all_gather(t[None], "ensemble", axis=0)),
                ("ppermute_ensemble",
                 lambda t: ppermute_shift(t, "ensemble", shift=1)),
                ("ppermute_back",
                 lambda t: ppermute_shift(t, "ensemble", shift=-1)),
                ("ppermute_tree",
                 lambda t: sum(ppermute_shift((t, 2 * t), "data"))),
        ):
            y = fn(mine)
            w = torch.arange(y.numel(), dtype=y.dtype).view(y.shape)
            (g,) = torch.autograd.grad((y * w).sum(), mine)
            results[name] = (y.detach(), g)
        grads = pmean_grads({"a": mine.detach() * 1.0,
                             "b": mine.detach().double()}, "data")
    return (results, grads, dict(mesh.coords), plan.n_devices,
            "jax" in sys.modules)


def _ring_model(kw, variables, mesh, seq, heads, impl):
    model = LongContextClassifier(attn_impl="ring", mesh=mesh, seq_axis=seq,
                                  head_axis=heads, ring_chunk_impl=impl,
                                  **kw, device="cpu")
    return load_flax_variables(model, variables)


def ring_fits(rank, world, meshes, kw, variables, data, batch, cfg_kw, cw):
    """``ring_fit`` on each of ``meshes`` ((shape, axis names, seq axis,
    head axis, ring chunk), each over the whole world) in turn; and
    whether JAX was imported."""
    return ([ring_fit(m, kw, variables, data, batch, cfg_kw, cw)
             for m in meshes], "jax" in sys.modules)


def ring_fit(mesh_spec, kw, variables, data, batch, cfg_kw, cw):
    """One gradient of a train step on ``batch`` (the mean over the mesh,
    as ``fit`` applies it) and the loss history of ``fit`` from
    ``variables``, of the ring model on this rank's time slices, with the
    shuffle the identity (as the JAX side has it). Returns (state-dict
    keys, loss, gradients by name, history, final params, mesh coords)."""
    shape, names, seq, heads, impl = mesh_spec
    mesh = _mesh(shape, names)
    cfg = TrainConfig(**cfg_kw)
    cw = torch.from_numpy(cw)
    model = _ring_model(kw, variables, mesh, seq, heads, impl)
    local = {k: torch.from_numpy(v)
             for k, v in shard_sequence(batch, mesh, seq).items()}
    loss = TrainStep(model, cfg).backward(local, cw)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    keys = list(model.state_dict())
    model = _ring_model(kw, variables, mesh, seq, heads, impl)
    real = torch.randperm
    torch.randperm = lambda n, generator=None, device=None: torch.arange(
        n, device=device)
    try:
        res = make_fit_fn(model, cfg, eval_names=())(
            0, shard_sequence(data, mesh, seq), {}, cw)
    finally:
        torch.randperm = real
    return (keys, loss.item(), grads, res.history["train_loss"],
            {k: p.detach() for k, p in model.named_parameters()},
            dict(mesh.coords))


def failing_rank(rank, world):
    """Rank 1 asks for a ring of the wrong size and raises; rank 0 returns."""
    from multimodal_eeg_fmri_tpu_torch.ops.ring_attention import (
        ring_attention_local,
    )

    mesh = _mesh((world,), ("data",))       # collective: every rank
    if rank == 1:
        x = torch.zeros(1, 1, 4, 8)
        ring_attention_local(x, x, x, "data", world + 1, mesh=mesh)
    return None
