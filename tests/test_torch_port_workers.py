"""Rank bodies of the port's parallel tests (no test of its own), run by
``parallel.distributed.spawn_local_world`` in spawned processes. This module
imports the port and never JAX, so that its workers do not either: each
returns ``"jax" in sys.modules`` beside its results, and the tests check it.

Arrays go in as numpy (the tests' seeded inputs) and come out as tensors or
numpy; a rank's results are its own shards, which the tests reassemble.
"""

from __future__ import annotations

import importlib
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

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
WAIT_S = 30.0       # the longest any thread of a rank may wait


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
    real = _identity_shuffle()
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


def _identity_shuffle():
    """``fit``'s shuffle as the identity, as the JAX side has it (its
    ``jax.random.permutation`` patched); returns the real ``randperm``."""
    real = torch.randperm
    torch.randperm = lambda n, generator=None, device=None: torch.arange(
        n, device=device)
    return real


def _history(res):
    return {k: v.clone() for k, v in res.history.items()}


def pipeline_cases(rank, world, stages, x, apply_cases, fits, cfg_kw):
    """The pipeline's cases on stage meshes of the whole world.

    ``stages`` {"w": (S, d, d), "b": (S, d)} and ``x``: ``pipeline_apply``
    of a residual GELU MLP stage on a ("stage",) mesh, forward at each
    ``apply_cases`` n_micro (the outputs) and, at the last, the gradient of
    sum(out²) in this rank's stage (reduced as ``fit`` reduces it). ``fits``
    {name: (mesh shape, axis names, model kwargs, flax params, data, torch
    seed)}: the ``PipelinedLongContextClassifier`` fit's history on that
    mesh, with the shuffle the identity and the default generator seeded
    first. Returns (apply results, fit histories, each fit's full state
    dict's keys, whether JAX was imported)."""
    from multimodal_eeg_fmri_tpu_torch.models import (
        PipelinedLongContextClassifier,
    )
    from multimodal_eeg_fmri_tpu_torch.models.layers import gelu
    from multimodal_eeg_fmri_tpu_torch.parallel import pipeline_apply
    from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
        reduce_grads_,
    )
    from multimodal_eeg_fmri_tpu_torch.parallel.pipeline import (
        shard_stage_params,
    )

    mesh = _mesh((world,), ("stage",))
    mine = shard_stage_params({k: torch.from_numpy(v)
                               for k, v in stages.items()}, mesh)
    mine = {k: v.clone().requires_grad_() for k, v in mine.items()}

    def stage(p, h):
        return gelu(h @ p["w"] + p["b"]) + h

    applied = {}
    xt = torch.from_numpy(x)
    for n_micro in apply_cases:
        applied[n_micro] = pipeline_apply(mine, xt, stage, mesh,
                                          n_micro=n_micro).detach()
    y = pipeline_apply(mine, xt[:16], stage, mesh, n_micro=apply_cases[-1])
    (y * y).sum().backward()
    grads = {k: v.grad for k, v in mine.items()}
    reduce_grads_(grads, {k: ("stage",) for k in grads}, mesh)

    histories, keys = {}, {}
    real = _identity_shuffle()
    try:
        for name, (shape, names, kw, params, data, seed) in fits.items():
            fmesh = _mesh(shape, names)
            model = load_flax_variables(
                PipelinedLongContextClassifier(mesh=fmesh, **kw,
                                               device="cpu"), params)
            local = data
            if "seq" in names:
                local = shard_sequence(data, fmesh, "seq")
            torch.manual_seed(seed)
            res = make_fit_fn(model, TrainConfig(**cfg_kw), eval_names=())(
                0, local, {})
            histories[name] = _history(res)
            keys[name] = sorted(model.full_state_dict())
    finally:
        torch.randperm = real
    return ((applied, grads), histories, keys, "jax" in sys.modules)


def _v4(kw, variables):
    """A narrow ``TriModalFusionNetV4`` on the CPU from flax variables, the
    fusion gate's fixed dropout off (as the JAX side patches flax's)."""
    from multimodal_eeg_fmri_tpu_torch.models import TriModalFusionNetV4
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion

    model = load_flax_variables(TriModalFusionNetV4(**kw, device="cpu"),
                                variables["params"],
                                variables.get("batch_stats"))
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    return model


def _layout(kind, mesh):
    from multimodal_eeg_fmri_tpu_torch.parallel import (
        ep_param_constraint,
        ep_param_specs,
        fsdp_param_constraint,
        shard_params_fsdp,
        tp_param_constraint,
    )

    return {"tp": lambda: tp_param_constraint(mesh),
            "fsdp": lambda: fsdp_param_constraint(mesh),
            "fsdp_tp": lambda: fsdp_param_constraint(mesh, tp=True),
            "ep": lambda: ep_param_constraint(mesh),
            "fsdp_ep": lambda: lambda m: shard_params_fsdp(
                m, mesh, base=ep_param_specs(m, mesh.shape["expert"]),
                min_size=2 ** 6),
            }[kind]()


def _step_grads(model, cfg, train, layout):
    """The first step's gradient of ``model`` laid out by ``layout``: the
    first ``cfg.batch_size`` rows, reduced as ``fit`` reduces it and
    gathered to full tensors, and its global norm (the clip's)."""
    from multimodal_eeg_fmri_tpu_torch.parallel.layout import full_tree

    layout(model)
    step = TrainStep(model, cfg)
    step.backward({k: torch.from_numpy(np.asarray(v[:cfg.batch_size]))
                   for k, v in train.items()})
    grads = full_tree(model, {k: p.grad for k, p in
                              model.named_parameters()})
    return grads, step.grad_norm()


def _sharded_fits(fits):
    """``sharded_fits``' fits: {name: (history, {param: (local numel,
    spec)}, AdamW's local numel, (first step's full gradient, its
    norm))}."""
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier

    out = {}
    real = _identity_shuffle()
    try:
        for name, (kind, shape, names, arch, kw, variables, train, evals,
                   cfg_kw, cw) in fits.items():
            mesh = _mesh(shape, names)

            def build():
                if arch == "v4":
                    return _v4(dict(kw, mesh=mesh) if "ep" in kind else kw,
                               variables)
                return load_flax_variables(LongContextClassifier(
                    **kw, mesh=mesh, device="cpu"), variables["params"])

            cfg = TrainConfig(**cfg_kw)
            grads = _step_grads(build(), cfg, train, _layout(kind, mesh))
            model = build()
            fit = make_fit_fn(model, cfg, eval_names=tuple(evals),
                              param_sharding=_layout(kind, mesh))
            res = fit(0, train, evals,
                      None if cw is None else torch.from_numpy(cw))
            opt = res.carry.opt_state["exp_avg"]
            out[name] = (_history(res),
                         {k: (p.numel(), model.param_specs.get(k, ()))
                          for k, p in model.named_parameters()},
                         sum(v.numel() for v in opt.values()), grads)
    finally:
        torch.randperm = real
    return out


def sharded_fits(rank, world, fits, resume):
    """``fits`` {name: (layout, mesh shape, axis names, model ("v4" or
    "lc"), model kwargs, flax variables, train, evals, config kwargs,
    class weights)}: one ``fit`` of the model laid out on that mesh, the
    shuffle the identity. Returns per fit (history, each parameter's local
    numel and spec, AdamW's local numel, the first step's full gradient
    and its norm). ``resume`` (an FSDP
    ``fit_resumable`` with grad-accum and EMA that crashes in its second
    chunk and resumes, or None): (kwargs, flax variables, train, val,
    config kwargs, checkpoint dir) → its history."""
    from multimodal_eeg_fmri_tpu_torch.train.resilient import fit_resumable

    out = _sharded_fits(fits)
    if resume is not None:
        kw, variables, train, val, cfg_kw, ckpt = resume
        mesh = _mesh((world,), ("data",))
        cfg = TrainConfig(**cfg_kw)
        crash = {"calls": 0}

        def augment(generator, batch):
            crash["calls"] += 1
            if crash["calls"] == crash.get("at", 0):
                raise RuntimeError("crash")
            return batch

        model = _v4(kw, variables)
        crash["at"] = cfg.num_epochs // 2 * (len(train["label"])
                                             // cfg.batch_size) + 1
        try:
            fit_resumable(model, cfg, 0, train, {"val": val}, ckpt,
                          chunk_epochs=cfg.num_epochs // 2, async_save=True,
                          param_sharding=_layout("fsdp", mesh),
                          augment=augment)
            raise AssertionError("the run did not crash")
        except RuntimeError as e:
            assert str(e) == "crash"
        crash["at"] = 0
        res = fit_resumable(_v4(kw, variables), cfg, 0, train, {"val": val},
                            ckpt, chunk_epochs=cfg.num_epochs // 2,
                            async_save=True,
                            param_sharding=_layout("fsdp", mesh),
                            augment=augment)
        out["resume"] = _history(res)
    return out, "jax" in sys.modules


def expert_cases(rank, world, fits, ring, capacity):
    """The expert-parallel cases: ``fits`` as in ``sharded_fits``; ``ring``
    (model kwargs, flax params, data, config kwargs): the
    ``LongContextClassifier`` with MoE blocks on a ring of the whole world,
    its history; ``capacity`` (MoE kwargs, flax variables, x (B, T, D), g):
    the layer on a (data 2 × expert 2) mesh with this rank's rows, its
    output rows and the gradients of Σ out·g in x and the parameters
    (reduced as ``fit`` reduces them), and the tokens it dropped."""
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
    from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN
    from multimodal_eeg_fmri_tpu_torch.parallel import (
        MeshPlan,
        batch_sharded,
        global_batch_tree,
        shard_params_ep,
    )
    from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
        reduce_grads_,
    )
    from multimodal_eeg_fmri_tpu_torch.parallel.layout import param_axes

    out = _sharded_fits(fits)
    kw, params, data, cfg_kw = ring
    mesh = _mesh((world,), ("seq",))
    model = load_flax_variables(LongContextClassifier(
        **kw, attn_impl="ring", mesh=mesh, seq_axis="seq", device="cpu"),
        params)
    real = _identity_shuffle()
    try:
        res = make_fit_fn(model, TrainConfig(**cfg_kw), eval_names=())(
            0, shard_sequence(data, mesh, "seq"), {})
    finally:
        torch.randperm = real
    out["ring"] = _history(res)

    moe_kw, variables, x, g = capacity
    mesh = _mesh((2, world // 2), ("data", "expert"))
    holder = torch.nn.Module()
    holder.moe = load_flax_variables(
        MoEFFN(**moe_kw, mesh=mesh, expert_axis="expert", device="cpu"),
        variables["params"])
    shard_params_ep(holder, mesh)
    plan = MeshPlan(mesh)
    xl = torch.from_numpy(global_batch_tree(plan, x)).requires_grad_()
    gl = torch.from_numpy(global_batch_tree(plan, g))
    with batch_sharded(mesh, "data"):
        y = holder.moe(xl)
        route = holder.moe.routing(xl.detach())
    loss = psum((y * gl).sum(), "data", mesh)
    loss.backward()
    grads = {"x": xl.grad, **{k: p.grad for k, p in
                              holder.named_parameters()}}
    reduce_grads_(grads, {**param_axes(holder), "x": ("data",)}, mesh)
    kept = int(route.keep.sum().item())
    out["capacity"] = (y.detach(), grads, kept)
    return out, "jax" in sys.modules


def _narrow_v4(kw, flash=False):
    """A narrow ``TriModalFusionNetV4`` on the CPU, the fusion gate's fixed
    dropout off; with ``flash`` every attention layer on the flash route."""
    from multimodal_eeg_fmri_tpu_torch.models import TriModalFusionNetV4
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention

    model = TriModalFusionNetV4(**kw, device="cpu")
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
        if flash and isinstance(m, MultiHeadAttention):
            m.attn_impl = "flash"
    return model


def hpo_space(**arch):
    """A search space with lr and wd drawn and the architecture ``arch``
    (each a tuple of choices)."""
    from multimodal_eeg_fmri_tpu_torch.train import hpo

    return {"lr": hpo.LogUniform(1e-3, 3e-2), "wd": hpo.LogUniform(1e-6, 1e-2),
            **{k: hpo.Choice(v) for k, v in arch.items()}}


def hpo_study(kw, train, val, space, mesh_plan=None):
    """``run_hpo`` over narrow V4s of ``space`` (5 trials, 1 proxy and 1 full
    epoch, 2 finalists) on ``mesh_plan``."""
    from multimodal_eeg_fmri_tpu_torch.train.hpo import run_hpo

    return run_hpo(lambda **arch: _narrow_v4({**kw, **arch}),
                   TrainConfig(batch_size=len(train["label"]),
                               schedule="constant", patience=100, seed=3),
                   train, val, space=space, n_trials=5, proxy_epochs=1,
                   full_epochs=1, top_fraction=0.4, seed=3,
                   mesh_plan=mesh_plan)


def ensemble_cases(rank, world, meshes, cv, sweep, hpo, serve):
    """The ensemble axis's callers on each (ensemble, data) mesh of
    ``meshes`` over the whole world. ``cv`` (model kwargs, cohort, config
    kwargs, normalize keys, initial variables): ``run_cv`` over 3
    eeg_kfold_splits folds; ``sweep`` (model kwargs, train, val, config
    kwargs, seeds): ``run_seed_sweep``, and its error for seeds that do not
    divide the ensemble axis; ``hpo`` (model kwargs, train, val, arch
    choices): ``hpo_study``; ``serve`` (mesh, model kwargs, K members' flax
    variables, rows, labels, batch size, artifact path): the planned
    ``EnsemblePredictor``'s three reductions, its calibration, the flash
    calls of one batch, the "not divisible" error and the export, and a
    planned ``DynamicBatcher`` over it for ``mean_probs`` and ``vote``
    (``serve_batched``). Returns ({case: result}, whether JAX was
    imported)."""
    from multimodal_eeg_fmri_tpu_torch.serving import EnsemblePredictor
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        eeg_kfold_splits,
        run_cv,
        run_seed_sweep,
    )

    # the module (``ops.attention`` the package attribute is the function)
    port_attn = importlib.import_module(
        "multimodal_eeg_fmri_tpu_torch.ops.attention")
    out = {}
    kw, data, cfg_kw, keys, variables = cv
    cfg = TrainConfig(**cfg_kw)
    splits = eeg_kfold_splits(data, cfg, n_splits=3)
    s_kw, s_train, s_val, s_cfg, n_seeds = sweep
    h_kw, h_train, h_val, arch = hpo
    for shape in meshes:
        plan = build_mesh(*shape)
        out["cv", shape] = run_cv(_narrow_v4(kw), cfg, data, splits,
                                  normalize_keys=keys,
                                  initial_variables=variables,
                                  mesh_plan=plan)
        out["sweep", shape] = run_seed_sweep(
            _narrow_v4(s_kw), TrainConfig(**s_cfg), s_train, {"val": s_val},
            n_seeds, mesh_plan=plan)
        try:
            run_seed_sweep(_narrow_v4(s_kw), TrainConfig(**s_cfg), s_train,
                           {"val": s_val}, n_seeds + 1, mesh_plan=plan)
            out["sweep_error", shape] = None
        except ValueError as e:
            out["sweep_error", shape] = str(e)
        out["hpo", shape] = hpo_study(h_kw, h_train, h_val,
                                      hpo_space(**arch), plan)

    shape, kw, members, rows, labels, batch, path = serve
    plan = build_mesh(*shape)
    models = [load_flax_variables(_narrow_v4(kw, flash=True), v["params"],
                                  v["batch_stats"]) for v in members]
    calls = []
    real = port_attn._flash_forward

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    served = {}
    for reduce in ("mean_probs", "vote", "none"):
        ens = EnsemblePredictor.from_modules(models, batch_size=batch,
                                             reduce=reduce, plan=plan)
        port_attn._flash_forward = spy
        try:
            served[reduce] = ens(**rows)
        finally:
            port_attn._flash_forward = real
        served["calls", reduce] = list(calls)
        calls.clear()
        if reduce != "none":
            served["batcher", reduce] = serve_batched(rank, ens, rows)
    ens = EnsemblePredictor.from_modules(models, batch_size=batch, plan=plan)
    cal = ens.calibrated(rows, labels)
    served["temperature"] = cal.temperature
    served["calibrated"] = cal(**rows)
    served["export"] = ens.export_artifact(rows, path)
    try:
        EnsemblePredictor.from_modules(models[:3], plan=plan)
        served["error"] = None
    except ValueError as e:
        served["error"] = str(e)
    out["serve"] = served
    return out, "jax" in sys.modules


def multihost_cases(rank, world, kw, cfg_kw, folds_kw, dp):
    """``examples/multihost_cpu.py``'s flow on the world, 2 ranks a host.
    Phase 1: a hybrid (ensemble 2, data 2) mesh; each host loads only its
    ``process_fold_range`` block of ``_multihost_folds(**folds_kw)`` and
    trains it (fold i from the streams of ``fold_in(0, i)``); the histories
    gathered over the ensemble axis. A (ensemble 2, data 2, model 1) mesh's
    ``psum`` over two axes of it. Phase 2: a flat (ensemble 1, data 4) mesh
    trains the fold ``dp`` (train, val) with its batch over ``data``."""
    from multimodal_eeg_fmri_tpu_torch.core.rng import fold_in
    from multimodal_eeg_fmri_tpu_torch.parallel import (
        build_hybrid_mesh,
        gather_ensemble_tree,
        process_fold_range,
    )
    from multimodal_eeg_fmri_tpu_torch.train.cv import fold_rngs, start_fold

    hosts, per_host = 2, world // 2
    plan = build_hybrid_mesh(ensemble=2, data=2, ranks_per_host=per_host)
    rows = plan.mesh.ranks // per_host
    assert all(len(set(r)) == 1 for r in rows.tolist()), rows
    n_folds = plan.n_ensemble
    lo, hi = process_fold_range(n_folds, plan, process_index=rank // per_host,
                                num_processes=hosts)
    local = multihost_folds(n_folds, plan.n_data, lo, hi, **folds_kw)
    cfg = TrainConfig(**cfg_kw)
    model = _narrow_v4(kw)
    fit = make_fit_fn(model, cfg, eval_names=("val",))
    hist = []
    for i, (train, val) in zip(range(lo, hi), local):
        rngs = fold_rngs(fold_in(0, i), "cpu")
        start_fold(model, rngs)
        hist.append(fit(rngs.shuffle, train, {"val": val}).history)
    history = gather_ensemble_tree(plan, {
        k: torch.stack([h[k] for h in hist]) for k in hist[0]})

    three = Mesh(np.arange(world).reshape(2, 2, 1),
                 ("ensemble", "data", "model"))
    mine = torch.tensor([float(rank)])
    sums = {axes: psum(mine, axes, three) for axes in (
        ("ensemble", "data"), ("data", "model"), ("ensemble", "model"),
        ("data", "ensemble"))}

    flat = build_mesh(ensemble=1, data=world)
    train, val = dp
    model = _narrow_v4({**kw, "mesh": flat.mesh})
    start_fold(model, fold_rngs(7, "cpu"))
    res = make_fit_fn(model, TrainConfig(**{**cfg_kw, "batch_size": 8}),
                      eval_names=("val",))(7, train, {"val": val})
    return ((lo, hi), history, sums, _history(res), "jax" in sys.modules)


def multihost_folds(n_folds, dp, lo=0, hi=None, seed=0, time_steps=32):
    """Folds ``lo``..``hi`` of ``examples/multihost_cpu.py``'s
    deterministic per-fold (train, eval) arrays: fold f draws its own row
    range of one synthetic cohort, so a fold mixed up across ranks shows as
    a wrong loss."""
    from multimodal_eeg_fmri_tpu_torch.data.arrays import pad_rows, subset
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )

    B = 2 * dp
    rows = 3 * B
    raw = synthetic_eeg_trimodal(n_subjects=n_folds * rows,
                                 time_steps=time_steps, seed=seed)
    raw.pop("subject")
    out = []
    for f in range(lo, n_folds if hi is None else hi):
        start = f * rows
        out.append((pad_rows(subset(raw, np.arange(start, start + 2 * B)),
                             2 * B),
                    pad_rows(subset(raw, np.arange(start + 2 * B,
                                                   start + 3 * B)), B)))
    return out


def run_threads(fn, n):
    """``fn(i)`` on ``n`` threads, each joined within WAIT_S; raises the
    first exception any of them raised."""
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        if t.is_alive():
            raise RuntimeError("a request thread hung")
    if errors:
        raise errors[0]


def serve_batched(rank, predictor, rows, **kw):
    """A planned ``DynamicBatcher`` over ``predictor``, built on every
    rank: rank 0 sends each row of ``rows`` from a thread of its own, and
    every rank closes it twice. Returns (rank 0's rows in order, None
    elsewhere; ``batches``; ``rows``; whether its worker still runs)."""
    from multimodal_eeg_fmri_tpu_torch.serving import DynamicBatcher

    b = DynamicBatcher(predictor, max_delay_ms=20.0, timeout_s=WAIT_S, **kw)
    got = None
    if rank == 0:
        n = len(next(iter(rows.values())))
        out = {}
        run_threads(lambda i: out.__setitem__(i, b(**{
            k: v[i:i + 1] for k, v in rows.items()})), n)
        got = np.concatenate([out[i] for i in range(n)])
    b.close()
    b.close()
    return got, b.batches, b.rows, b._worker.is_alive()


class MeshStub:
    """A planned predictor as the batcher sees it (``_plan``, ``device``,
    ``batch_size``): a call sums x·(rank + 1) over the mesh's ensemble axis
    (``psum``), x the request's arrays side by side as float64, and records
    (sorted keys, rows). A request with the key ``boom`` raises on every
    rank after its psum; ``hold``, where given, is waited for before it."""

    def __init__(self, plan, hold=None):
        self._plan = plan
        self.device = torch.device("cpu")
        self.batch_size = 8
        self.hold = hold
        self.seen = []

    def __call__(self, **inputs):
        self.seen.append((tuple(sorted(inputs)),
                          len(next(iter(inputs.values())))))
        if self.hold is not None:
            self.hold.wait(WAIT_S)
        x = np.concatenate([np.asarray(v, np.float64).reshape(len(v), -1)
                            for _, v in sorted(inputs.items())], 1)
        total = psum(torch.from_numpy(x) * (dist.get_rank() + 1),
                     "ensemble", self._plan.mesh)
        if "boom" in inputs:
            raise RuntimeError("device fault")
        return total.numpy()


BROADCAST_CASE = {
    "f32": np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7,
    "f64": np.linspace(-1, 1, 5),
    "i64": np.arange(-3, 3, dtype=np.int64).reshape(3, 2),
    "mask": np.array([[True, False, True]]),
    "u8": np.arange(7, dtype=np.uint8),
    "half": np.array([1.5, -2.25], np.float16),
    "scalar": np.float32(3.5),
    "none": np.zeros((0, 4), np.float32),
    "strided": np.arange(12.0).reshape(3, 4)[:, ::2],
}


def batcher_cases(rank, world):
    """The planned ``DynamicBatcher``'s protocol on an ensemble axis of the
    whole world, over ``MeshStub``s; rank 0 is the front, the others build
    each batcher with the same arguments and close it twice. The cases, in
    order: ``broadcast`` of ``BROADCAST_CASE`` and of a stop on a group of
    its own, and a string array refused on the sender; two key sets in one
    flush; a 3-row request flushed at the deadline; an error every rank
    raises and a join error, each delivered on the front, then a good call;
    ``QueueFull`` and a timeout while a call is held; a follower's
    ``__call__``; a broadcast that fails on every rank. Returns ({case:
    this rank's record}, whether JAX was imported)."""
    from multimodal_eeg_fmri_tpu_torch.parallel.collectives import broadcast
    from multimodal_eeg_fmri_tpu_torch.serving import (
        DynamicBatcher,
        QueueFull,
    )

    plan = build_mesh(ensemble=world)
    front = rank == 0
    out = {}

    group = dist.new_group(list(range(world)))
    sent = BROADCAST_CASE if front else None
    got = broadcast(sent, 0, group)
    stop = broadcast(None, 0, group)
    refused = None
    if front:
        try:
            broadcast({"s": np.array(["a"])}, 0, group)
        except TypeError as e:
            refused = str(e)
    out["broadcast"] = (got, stop, refused)

    def batcher(stub, **kw):
        kw = {"max_delay_ms": 200.0, "timeout_s": WAIT_S, **kw}
        return DynamicBatcher(stub, **kw)

    def finish(name, b, stub, record):
        t0 = time.perf_counter()
        b.close()
        b.close()
        out[name] = {**record, "seen": stub.seen, "batches": b.batches,
                     "rows": b.rows, "alive": b._worker.is_alive(),
                     "close_s": time.perf_counter() - t0,
                     "rejected": b.rejected}

    def one(b, /, **arrays):
        """A request's result, or its error's (type, message)."""
        try:
            return b(**arrays)
        except Exception as e:  # noqa: BLE001 -- recorded
            return type(e).__name__, str(e)

    # two key sets in one flush
    stub = MeshStub(plan)
    b = batcher(stub, max_batch=8)
    got = {}
    if front:
        keys = ("a", "b")
        run_threads(lambda i: got.__setitem__(i, one(b, **{
            keys[i % 2]: np.full((1, 2), float(i))})), 4)
    finish("keys", b, stub, {"got": got})

    # a multi-row request alone: flushed at the deadline
    stub = MeshStub(plan)
    b = batcher(stub, max_delay_ms=1.0)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    finish("deadline", b, stub, {"got": one(b, x=x) if front else None})

    # an error of the call on every rank; a group that cannot be joined
    stub = MeshStub(plan)
    b = batcher(stub, max_batch=8)
    got = {}
    if front:
        got["boom"] = one(b, x=np.ones((1, 2)), boom=np.ones((1, 1)))
        widths = (2, 3)
        run_threads(lambda i: got.__setitem__(i, one(
            b, x=np.ones((1, widths[i])))), 2)
        got["after"] = one(b, x=np.full((2, 2), 2.0))
    finish("errors", b, stub, {"got": got})

    # QueueFull and a timeout while the front's call is held
    hold = threading.Event() if front else None
    stub = MeshStub(plan, hold)
    b = batcher(stub, max_delay_ms=1.0, max_batch=1, max_queue=2,
                timeout_s=1.0)
    got = {}
    if front:
        held = threading.Thread(target=lambda: got.__setitem__(
            "held", one(b, x=np.ones((1, 2)))))
        held.start()
        deadline = time.monotonic() + WAIT_S
        while not stub.seen and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = threading.Thread(target=lambda: got.__setitem__(
            "queued", one(b, x=np.ones((2, 2)))))
        queued.start()
        while time.monotonic() < deadline:
            with b._cv:
                if b._queue:
                    break
            time.sleep(0.005)
        try:
            b(x=np.ones((1, 2)))
        except QueueFull as e:
            got["full"] = str(e)
        queued.join(WAIT_S)
        with b._cv:
            got["left"] = len(b._queue)
        hold.set()
        held.join(WAIT_S)
        got["hung"] = held.is_alive() or queued.is_alive()
        got["after"] = one(b, x=np.full((1, 2), 3.0))
    finish("queue", b, stub, {"got": got})

    # a follower takes no request
    stub = MeshStub(plan)
    b = batcher(stub)
    call = None if front else one(b, x=np.ones((1, 2)))
    finish("follower_call", b, stub, {"got": call})
    if front:
        out["closed"] = one(b, x=np.ones((1, 2)))

    # a broadcast that fails (here on every rank, at its first batch)
    # stops the batcher: no rank carries on
    serving = importlib.import_module("multimodal_eeg_fmri_tpu_torch.serving")

    def broken(arrays, src, group):
        raise ConnectionError("the group failed")

    serving.broadcast = broken
    try:
        stub = MeshStub(plan)
        b = batcher(stub, max_delay_ms=1.0)
        got = {}
        if front:
            got["first"] = one(b, x=np.ones((1, 2)))
            got["later"] = one(b, x=np.ones((1, 2)))
        closes = [one(b.close) for _ in range(2)]
        out["broken"] = {"got": got, "closes": closes, "seen": stub.seen,
                         "alive": b._worker.is_alive(),
                         "cause": repr(b._error)}
    finally:
        serving.broadcast = broadcast
    return out, "jax" in sys.modules


def batcher_world_of_one(rank, world):
    """A ``DynamicBatcher`` over a ``MeshStub`` on a plan of the world of
    one, which has a process group: the planned mode, its broadcasts on a
    group of one. Returns (requests' results, counters, whether it made a
    group, the stub's calls, whether JAX was imported)."""
    from multimodal_eeg_fmri_tpu_torch.serving import DynamicBatcher

    stub = MeshStub(build_mesh())
    x = np.arange(10.0).reshape(5, 2)
    with DynamicBatcher(stub, max_delay_ms=1.0, timeout_s=WAIT_S) as b:
        got = [b(x=x[lo:hi]) for lo, hi in ((0, 3), (3, 5))]
    return (got, (b.batches, b.rows), b._group is not None, stub.seen,
            "jax" in sys.modules)


def ensemble_vmap_cases(rank, world, kw, stacked, data, data_k):
    """``parallel.ensemble_vmap`` of a flash-routed narrow V4's eval-mode
    logits over the fold-stacked ``stacked`` weights: shared inputs on an
    (ensemble 2) mesh and on a (data 2) mesh, whose ranks repeat every
    fold; and every argument mapped (``data_k``, each member its rows)."""
    from torch.func import functional_call

    from multimodal_eeg_fmri_tpu_torch.parallel import (
        build_mesh,
        ensemble_vmap,
    )

    model = _narrow_v4(kw, flash=True).eval()

    def member(tensors, inputs):
        return functional_call(model, tensors, (), inputs).logits

    out = {}
    with torch.no_grad():
        for name, (e, d) in (("ensemble", (2, 1)), ("data", (1, 2))):
            plan = build_mesh(ensemble=e, data=d)
            out[name] = ensemble_vmap(member, plan, in_axes=(0, None))(
                stacked, data)
        out["mapped"] = ensemble_vmap(member, build_mesh(ensemble=2))(
            stacked, data_k)
    return out, "jax" in sys.modules
