"""Fault-tolerant chunked training (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/train/resilient.py``.

Training runs in chunks of ``chunk_epochs``; after each chunk the whole
training carry (params, statistics, AdamW state, best-state tracking,
early-stop counters, plateau controller, both generators, epoch counter,
EMA) and the histories so far are written by ``core.checkpoint``'s
``save_checkpoint`` into ``chunk_NNNNN/``, and a ``_COMPLETE`` marker is
written last. On restart the latest complete chunk is loaded and training
continues where it left off: the schedule, early stopping and selection see
the state they would have seen in one run.

A model on a mesh (``param_sharding``, a pipeline's stages) checkpoints the
gathered full tensors (``parallel.layout.full_tree``, collective): rank 0
of the world writes, and a resume on any layout cuts them to its own
(``train.fit.localize_carry``).
"""

from __future__ import annotations

import json
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.parallel.layout import full_tree
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import world
from multimodal_eeg_fmri_tpu_torch.train.fit import (
    FitCarry,
    FitResult,
    localize_carry,
    make_fit_fn,
)


def _chunk_dir(ckpt_dir: Path, chunk: int) -> Path:
    return ckpt_dir / f"chunk_{chunk:05d}"


def latest_chunk(ckpt_dir: Union[str, Path]) -> Optional[int]:
    """The index of the last chunk whose write completed, or None."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    chunks = sorted(int(p.name.split("_")[1]) for p in d.glob("chunk_*")
                    if (p / "_COMPLETE").exists())
    return chunks[-1] if chunks else None


def _host_copy(x):
    """A copy of a nest of tensors on the CPU, which no later training
    step touches."""
    if torch.is_tensor(x):
        return x.to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x


def _save_chunk(cd: Path, carry: Dict[str, Any], histories) -> None:
    """A chunk's checkpoint: params, statistics and AdamW state in their
    slots, the rest of the carry and the histories as ``extra``."""
    rest = {k: v for k, v in carry.items()
            if k not in ("params", "batch_stats", "opt_state")}
    save_checkpoint(cd, carry["params"], batch_stats=carry["batch_stats"],
                    opt_state=carry["opt_state"], step=carry["epoch"],
                    extra={"carry": rest, "histories": histories})


def _load_chunk(cd: Path):
    """(carry, histories) of a chunk's checkpoint, on the CPU."""
    ck = load_checkpoint(cd)
    carry = FitCarry(params=ck["params"], batch_stats=ck["batch_stats"],
                     opt_state=ck["opt_state"], **ck["extra"]["carry"])
    return carry, ck["extra"]["histories"]


def _full_carry(model: nn.Module, carry: FitCarry) -> Dict[str, Any]:
    """The carry as a dict, every tree by parameter or state-dict name
    gathered to full tensors (collective over the model's mesh)."""
    def full(tree):
        return None if tree is None else full_tree(model, tree)

    out = carry._asdict()
    for k in ("params", "batch_stats", "best_params", "best_batch_stats",
              "ema_params"):
        out[k] = full(out[k])
    out["opt_state"] = {**carry.opt_state,
                        "exp_avg": full(carry.opt_state["exp_avg"]),
                        "exp_avg_sq": full(carry.opt_state["exp_avg_sq"])}
    return out


def _concat_histories(histories) -> Dict[str, torch.Tensor]:
    if not histories:
        return {}
    return {k: torch.cat([h[k] for h in histories]) for k in histories[0]}


def fit_resumable(model: nn.Module, cfg: TrainConfig,
                  generator: Union[torch.Generator, int],
                  train_data: Dict[str, Any],
                  eval_sets: Dict[str, Dict[str, Any]],
                  ckpt_dir: Union[str, Path], class_weights=None,
                  chunk_epochs: int = 10, keep_chunks: int = 2,
                  async_save: bool = False,
                  param_sharding: Optional[Callable] = None, *,
                  augment: Optional[Callable] = None,
                  preprocess: Optional[Callable] = None) -> FitResult:
    """Train ``cfg.num_epochs`` in chunks with durable checkpoints, the
    module in place. Safe to call again after a crash: it resumes from the
    last complete chunk into ``model`` (whatever weights it holds) and
    returns the whole run's history. ``augment`` and ``preprocess`` go to
    ``make_fit_fn``.

    ``async_save=True`` overlaps each chunk's write with the next chunk:
    the state is copied to the host before the next chunk starts, the write
    runs on a background thread, and the ``_COMPLETE`` marker is written only
    after the write has finished, so a crash mid-write leaves an incomplete
    chunk that a resume ignores. The JAX package also donates the resume
    carry's device buffers to each chunk; torch has no counterpart, and the
    carry of the previous chunk is freed when the next one replaces it.
    ``param_sharding`` goes to ``make_fit_fn``: each chunk lays the model
    out, a checkpoint keeps the gathered full tensors, which rank 0 of the
    world writes, and a resumed carry is cut back to the layout."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    spmd = getattr(model, "mesh", None) is not None or (
        param_sharding is not None)
    if spmd and dist.is_initialized():
        dist.barrier()  # every rank sees the same complete chunks
    writes = world()[0] == 0
    n_chunks = (cfg.num_epochs + chunk_epochs - 1) // chunk_epochs
    fit_fn = make_fit_fn(model, cfg, num_epochs=chunk_epochs,
                         eval_names=tuple(eval_sets.keys()),
                         augment=augment, preprocess=preprocess,
                         param_sharding=param_sharding)

    start, carry, histories = 0, None, []
    resumed = latest_chunk(ckpt_dir)
    if resumed is not None:
        carry, histories = _load_chunk(_chunk_dir(ckpt_dir, resumed))
        start = resumed + 1

    def finalize(cd: Path, chunk: int) -> None:
        (cd / "_COMPLETE").write_text(json.dumps({"chunk": chunk}))
        for old in sorted(ckpt_dir.glob("chunk_*"))[:-keep_chunks]:
            shutil.rmtree(old, ignore_errors=True)

    result = None
    pending = None  # (future, dir, chunk) of a write still in flight
    writer = (ThreadPoolExecutor(max_workers=1) if async_save and writes
              else None)
    try:
        for chunk in range(start, n_chunks):
            result = fit_fn(generator, train_data, eval_sets, class_weights,
                            None, carry)
            carry = result.carry
            histories.append({k: v.cpu() for k, v in result.history.items()})
            # the host copy, taken before the next chunk trains; the list is
            # copied so that the writer does not see the next append
            state = (_host_copy(_full_carry(model, carry) if spmd
                                else carry._asdict()), list(histories))
            if not writes:
                continue
            if pending is not None:
                pending[0].result()
                finalize(*pending[1:])
                pending = None
            cd = _chunk_dir(ckpt_dir, chunk)
            if cd.exists():
                shutil.rmtree(cd)
            cd.mkdir()
            if writer is None:
                _save_chunk(cd, *state)
                finalize(cd, chunk)
            else:
                pending = (writer.submit(_save_chunk, cd, *state), cd, chunk)
        if pending is not None:
            pending[0].result()
            finalize(*pending[1:])
    finally:
        # on an exception this waits for a write in flight but never marks
        # it complete
        if writer is not None:
            writer.shutdown(wait=True)

    history = _concat_histories(histories)
    if result is None:  # every chunk was done already
        if param_sharding is not None:
            param_sharding(model)
        if spmd:
            carry = localize_carry(model, carry)
        model.load_state_dict({**carry.params, **carry.batch_stats})
        model.eval()
        return FitResult(
            params=carry.best_params, batch_stats=carry.best_batch_stats,
            final_params=carry.params, final_batch_stats=carry.batch_stats,
            best_metric=carry.best_metric, best_epoch=carry.best_epoch,
            history=history, carry=carry)
    return result._replace(history=history)
