"""Inference and serving (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/serving.py``:

- ``Predictor``: a fixed-batch predictor that pads any request to whole
  batches by repeating row 0, runs the model in eval mode and returns f32
  probabilities (or logits), with an optional temperature before the
  softmax; built from a module, a checkpoint (``from_checkpoint``) or an
  int8/int4 payload (``from_quantized``); ``calibrated`` fits the
  temperature on held-out data.
- ``export_artifact`` / ``load_artifact``: the served forward, weights
  included, as a ``torch.export`` program in one file.
- ``EnsemblePredictor``: K member models in one ``torch.func.vmap`` of
  ``functional_call`` over their stacked weights. The flash forward K1
  folds the member axis into its batch (``ops/attention.py``), so a served
  batch launches it once per attention layer, not once per member. With a
  ``plan`` (``parallel.build_mesh``) the members shard over the mesh's
  ensemble axis: each rank serves its block in that one forward and the
  reduction crosses ranks; a call is collective, every rank passing the
  same rows.
- ``DynamicBatcher``: coalesces concurrent small requests into one call,
  with a bounded queue (``QueueFull``) and a per-request timeout. Over a
  planned ``EnsemblePredictor`` it is collective: global rank 0 takes the
  requests and broadcasts each batch, and every rank makes the call.
"""

from __future__ import annotations

import copy
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from multimodal_eeg_fmri_tpu_torch.convert import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core.checkpoint import load_checkpoint
from multimodal_eeg_fmri_tpu_torch.core.profiling import annotate
from multimodal_eeg_fmri_tpu_torch.core.quantize import load_quantized
from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor
# registers mmef::flash_fwd, which the programs of load_artifact call
from multimodal_eeg_fmri_tpu_torch.ops import attention as _ops  # noqa: F401
from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    all_gather,
    broadcast,
    psum,
)
from multimodal_eeg_fmri_tpu_torch.parallel.input import gather_ensemble_tree
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    shard_ensemble_tree,
    world,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import RESERVED_KEYS


def _rows(inputs: Dict[str, np.ndarray]) -> int:
    return len(next(iter(inputs.values())))


def _pad_chunk(inputs: Dict[str, np.ndarray], start: int, batch_size: int):
    """(the ``batch_size`` rows from ``start``, real rows); a short chunk
    repeats its row 0."""
    chunk = {k: np.asarray(v)[start:start + batch_size]
             for k, v in inputs.items()}
    m = _rows(chunk)
    if m < batch_size:
        chunk = {k: np.concatenate(
            [v, np.repeat(v[:1], batch_size - m, axis=0)])
            for k, v in chunk.items()}
    return chunk, m


def _served(inputs: dict) -> dict:
    return {k: v for k, v in inputs.items() if k not in RESERVED_KEYS}


def _scaled_probs(logits: torch.Tensor, temperature: Optional[float],
                  probs: bool = True) -> torch.Tensor:
    logits = logits.float()
    if temperature is not None:
        logits = logits / temperature
    return torch.softmax(logits, dim=-1) if probs else logits


def _check_temperature(temperature) -> Optional[float]:
    if temperature is not None and temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    return float(temperature) if temperature is not None else None


class _PredictorNet(nn.Module):
    """What a ``Predictor`` serves, as a module (the exported program)."""

    def __init__(self, model: nn.Module, preprocess, temperature,
                 return_probs: bool):
        super().__init__()
        self.model = model
        self.preprocess = preprocess
        self.temperature = temperature
        self.return_probs = return_probs

    def forward(self, **inputs) -> torch.Tensor:
        if self.preprocess is not None:
            inputs = {**inputs, **self.preprocess(inputs)}
        return _scaled_probs(self.model(**inputs).logits, self.temperature,
                             self.return_probs)


class _Serving:
    """Batching, device transfer, export and timing shared by the two
    predictors; a subclass sets ``self.net``, ``self.batch_size`` and
    ``self.device``."""

    net: nn.Module
    batch_size: int
    device: torch.device

    def _to_device(self, chunk: Dict[str, np.ndarray]):
        """The chunk on the served device; float64 becomes float32, as the
        JAX package's ``jnp.asarray`` makes it."""
        return {k: as_tensor(v, self.device) for k, v in chunk.items()}

    def _forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return self.net(**inputs)

    def _outputs(self, inputs: Dict[str, np.ndarray]):
        """(the served output of a chunk of ``batch_size`` rows on the host,
        its real rows), chunk by chunk, each part in its span."""
        inputs = _served(inputs)
        for start in range(0, _rows(inputs), self.batch_size):
            with annotate("mmef/predict/h2d"):
                chunk, m = _pad_chunk(inputs, start, self.batch_size)
                dev = self._to_device(chunk)
            with annotate("mmef/predict/forward"):
                out = self._forward(dev)
            with annotate("mmef/predict/d2h"):
                host = out.cpu().numpy()
            yield host, m

    def export_artifact(self, example: Dict[str, np.ndarray],
                        path: str | Path) -> bytes:
        """Write the served forward, weights included, as a
        ``torch.export`` program (``torch.export.save``) and return the
        file's bytes; ``load_artifact`` serves it. The program is traced at
        this predictor's batch size from ``example``'s keys, shapes and
        dtypes, on this predictor's device, and runs there: an artifact
        exported on the card launches the flash kernel as ``mmef::flash_fwd``
        wherever the live predictor would."""
        chunk = self._to_device(
            _pad_chunk(_served(example), 0, self.batch_size)[0])
        with torch.no_grad():
            # lowered to ATen ops: vmap resolves into batched ops and the
            # folded ``mmef::flash_fwd`` call, with none of its own
            # plumbing left in the graph (which not every torch version
            # can serialize)
            program = torch.export.export(self.net, (), chunk
                                          ).run_decompositions({})
        path = Path(path)
        torch.export.save(program, path)
        return path.read_bytes()

    def benchmark(self, example: Dict[str, np.ndarray], warmup: int = 3,
                  iters: int = 30) -> Dict[str, float]:
        """Latency percentiles of one batch, host clock around a forward
        that ends in ``torch.cuda.synchronize()`` on a CUDA device."""
        dev = self._to_device(
            _pad_chunk(_served(example), 0, self.batch_size)[0])
        cuda = self.device.type == "cuda"

        def run():
            self._forward(dev)
            if cuda:
                torch.cuda.synchronize(self.device)

        for _ in range(warmup):
            run()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1000.0)
        a = np.asarray(times)
        return {"p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "mean_ms": float(a.mean()),
                "batch_size": self.batch_size,
                "device": (torch.cuda.get_device_name(self.device) if cuda
                           else str(self.device))}


class Predictor(_Serving):
    """Fixed-batch predictor over a model whose weights are loaded. The
    model is put in eval mode; inputs go to the device of its parameters."""

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 preprocess: Optional[Callable] = None,
                 return_probs: bool = True,
                 temperature: Optional[float] = None):
        self.model = model.eval()
        self.batch_size = batch_size
        # read-only after construction, as in the JAX Predictor
        self.temperature = _check_temperature(temperature)
        self._preprocess = preprocess
        self._return_probs = return_probs
        self.device = next(model.parameters()).device
        self.net = _PredictorNet(self.model, preprocess, self.temperature,
                                 return_probs)

    @classmethod
    def from_checkpoint(cls, model: nn.Module, checkpoint_path,
                        **kw) -> "Predictor":
        """Load a ``core/checkpoint.py`` checkpoint's params and statistics
        into ``model`` (strictly) and serve it."""
        return cls(_load_state(model, load_checkpoint(
            checkpoint_path, map_location=next(model.parameters()).device)),
            **kw)

    @classmethod
    def from_quantized(cls, model: nn.Module, path, **kw) -> "Predictor":
        """Load an int8/int4 weight-only payload (``core/quantize.py``,
        either package's) into ``model`` and serve it: weights dequantize
        at load, compute stays f32."""
        restored = load_quantized(path)
        return cls(load_flax_variables(model, restored["params"],
                                       restored.get("batch_stats")), **kw)

    def _logits(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """The model's raw logits for any number of rows, on the device."""
        out = []
        with torch.inference_mode():
            inputs = _served(inputs)
            for start in range(0, _rows(inputs), self.batch_size):
                chunk, m = _pad_chunk(inputs, start, self.batch_size)
                dev = self._to_device(chunk)
                if self._preprocess is not None:
                    dev = {**dev, **self._preprocess(dev)}
                out.append(self.model(**dev).logits[:m])
        return torch.cat(out)

    def calibrated(self, val_inputs: Dict[str, np.ndarray],
                   val_labels: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> "Predictor":
        """A new ``Predictor`` serving ``softmax(z / T)``, T fitted to
        minimize the validation NLL of this model's raw logits
        (``report/calibration.fit_temperature``)."""
        from multimodal_eeg_fmri_tpu_torch.report.calibration import (
            fit_temperature,
        )

        logits = self._logits(val_inputs)
        t = float(fit_temperature(
            logits, np.asarray(val_labels),
            weights=None if weights is None else np.asarray(weights)))
        return Predictor(self.model, batch_size=self.batch_size,
                         preprocess=self._preprocess,
                         return_probs=self._return_probs, temperature=t)

    def __call__(self, **inputs) -> np.ndarray:
        """Predict for any number of rows, in batches of ``batch_size``."""
        with annotate("mmef/predict"):
            return np.concatenate([out[:m] for out, m in
                                   self._outputs(inputs)], axis=0)


def _load_state(model: nn.Module, restored: dict) -> nn.Module:
    model.load_state_dict({**restored["params"],
                           **(restored.get("batch_stats") or {})})
    return model



def load_artifact(path: str | Path) -> Callable[..., np.ndarray]:
    """Load an ``export_artifact`` file into ``fn(**inputs) -> probs``.
    Inputs must have the exported batch size and keys. No model code is
    needed, but the port's operator library is: the program calls K1 as
    ``mmef::flash_fwd``, registered when ``ops/attention.py`` is imported
    (this module imports it). That is the one
    difference from a ``jax.export`` artifact, which carries its kernels
    compiled. The program runs on the device it was exported on."""
    program = torch.export.load(Path(path))
    tensors = [*program.state_dict.values(), *program.constants.values()]
    device = tensors[0].device if tensors else torch.device("cpu")
    fn = program.module()

    def call(**inputs) -> np.ndarray:
        dev = {k: as_tensor(v, device) for k, v in _served(inputs).items()}
        with torch.no_grad():
            return fn(**dev).cpu().numpy()

    return call


def stack_variable_trees(trees: Sequence[Dict[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """Stack K state dicts of one layout on a new leading member axis."""
    names = list(trees[0])
    for i, t in enumerate(trees[1:], 1):
        if list(t) != names:
            raise ValueError(f"member {i}'s tensors differ from member 0's: "
                             f"{sorted(set(t) ^ set(names))}")
    return {k: torch.stack([torch.as_tensor(t[k]) for t in trees])
            for k in names}


class _EnsembleNet(nn.Module):
    """What an ``EnsemblePredictor`` serves, as a module: the stacked
    member state is its buffers, so that an exported program carries it."""

    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor], preprocess, reduce: str,
                 temperature: Optional[float], plan=None,
                 n_members: int = 0):
        super().__init__()
        # the structure only: functional_call gives it every tensor it
        # reads, so it holds none (nor does an exported program)
        self.skeleton = copy.deepcopy(model).to("meta")
        for m in self.skeleton.modules():
            m._parameters.clear()
            m._buffers.clear()
            m._non_persistent_buffers_set.clear()
        self.names = (list(params), list(buffers))
        for i, t in enumerate(params.values()):
            self.register_buffer(f"p{i}", t)
        for i, t in enumerate(buffers.values()):
            self.register_buffer(f"b{i}", t)
        self.preprocess = preprocess
        self.reduce = reduce
        self.temperature = temperature
        # with a plan the state is this rank's block of the K members
        self.plan = plan
        self.n_members = n_members

    def state(self):
        params, buffers = self.names
        return ({n: getattr(self, f"p{i}") for i, n in enumerate(params)},
                {n: getattr(self, f"b{i}") for i, n in enumerate(buffers)})

    def member_logits(self, inputs: dict) -> torch.Tensor:
        """(K, B, C) logits, one vmapped forward over the stacked state."""
        def member(state, inputs):
            return torch.func.functional_call(
                self.skeleton, state, (), inputs).logits

        return torch.func.vmap(member, in_dims=(0, None))(self.state(),
                                                          inputs)

    def forward(self, **inputs) -> torch.Tensor:
        if self.preprocess is not None:
            inputs = {**inputs, **self.preprocess(inputs)}
        # the temperature sits inside each member's softmax: the fusion
        # averages probabilities, not logits
        probs = _scaled_probs(self.member_logits(inputs), self.temperature)
        if self.reduce == "none":
            return self.gather_members(probs)
        if self.reduce == "vote":
            # per-class vote fractions: their argmax is the majority vote
            probs = nn.functional.one_hot(
                probs.argmax(dim=-1), probs.shape[-1]).to(probs.dtype)
        if self.plan is None:
            return probs.mean(dim=0)
        # the ranks' sums over their members, summed over the ensemble axis
        return psum(probs.sum(dim=0), self.plan.ensemble_axis,
                    self.plan.mesh) / self.n_members

    def gather_members(self, member_axis: torch.Tensor) -> torch.Tensor:
        """A (k, ...) tensor of this rank's members as (K, ...) of all of
        them (the identity without a plan)."""
        if self.plan is None:
            return member_axis
        return all_gather(member_axis, self.plan.ensemble_axis, 0,
                          self.plan.mesh)


class EnsemblePredictor(_Serving):
    """Serve K member models (the folds of a CV run, say) in one forward:
    their weights stack on a leading member axis and ``torch.func.vmap``
    maps ``functional_call`` of ``model`` over it, in eval mode, the inputs
    shared. ``model`` gives the structure (its own weights are not used);
    the predictor runs on the device of the stacked weights.

    ``reduce="mean_probs"`` returns the late-fusion average (n, classes);
    ``"vote"`` per-class majority-vote fractions (n, classes), whose argmax
    is the members' majority vote; ``"none"`` each member's probabilities
    (K, n, classes). ``stacked_params`` and ``stacked_buffers`` are state
    dicts with the member axis first (``stack_variable_trees``,
    ``from_modules``).

    ``plan`` (a ``parallel.MeshPlan`` whose ensemble axis divides K) shards
    the members over the ranks, as the JAX package's ``ensemble_vmap`` does:
    every rank builds the predictor from all K members and keeps its
    contiguous block, and a call is collective over the mesh, the inputs
    the same on every rank (the JAX package's ``replicated`` inputs; ranks
    along the data axis repeat their row's members). ``mean_probs`` sums
    each rank's members' probabilities over the ensemble axis and divides
    by K, ``vote`` sums their one-hot votes alike, ``none`` gathers the
    members in order; every rank gets the result. ``calibrated`` fits T on
    all K members' logits; ``export_artifact`` writes the whole K-member
    function on global rank 0 (the unplanned predictor's program; the
    other ranks write nothing and return None)."""

    def __init__(self, model: nn.Module,
                 stacked_params: Dict[str, torch.Tensor],
                 stacked_buffers: Optional[Dict[str, torch.Tensor]] = None,
                 plan=None, batch_size: int = 8,
                 preprocess: Optional[Callable] = None,
                 reduce: str = "mean_probs",
                 temperature: Optional[float] = None):
        if reduce not in ("mean_probs", "vote", "none"):
            raise ValueError(f"unknown reduce={reduce!r}")
        self.model = model.eval()
        self.batch_size = batch_size
        self.reduce = reduce
        self.temperature = _check_temperature(temperature)
        self._preprocess = preprocess
        self._plan = plan
        self.n_members = int(next(iter(stacked_params.values())).shape[0])
        self.device = next(iter(stacked_params.values())).device
        stacked_buffers = stacked_buffers or {}
        if plan is not None:
            if self.n_members % plan.n_ensemble:
                raise ValueError(
                    f"{self.n_members} members not divisible by the mesh's "
                    f"ensemble axis ({plan.n_ensemble})")
            # this rank's block, apart from the K-member stack
            stacked_params, stacked_buffers = (
                {k: v.clone() for k, v in shard_ensemble_tree(
                    plan, tree).items()}
                for tree in (stacked_params, stacked_buffers))
        self.net = _EnsembleNet(self.model, stacked_params, stacked_buffers,
                                preprocess, reduce, self.temperature, plan,
                                self.n_members)

    def _whole_state(self):
        """(params, buffers) of all K members (collective with a plan)."""
        return gather_ensemble_tree(self._plan, self.net.state())

    @classmethod
    def from_modules(cls, models: Sequence[nn.Module],
                     **kw) -> "EnsemblePredictor":
        """Serve K modules of one architecture (``models[0]`` gives the
        structure), their parameters and buffers stacked as
        ``torch.func.stack_module_state`` stacks them."""
        return cls(models[0],
                   stack_variable_trees([{k: p.detach() for k, p in
                                          m.named_parameters()}
                                         for m in models]),
                   stack_variable_trees([dict(m.named_buffers())
                                         for m in models]), **kw)

    @classmethod
    def from_checkpoints(cls, model: nn.Module,
                         checkpoint_paths: Sequence, **kw
                         ) -> "EnsemblePredictor":
        """Build from K ``core/checkpoint.py`` checkpoints (the per-fold
        ``best_{model}_fold{k}`` layout), each loaded strictly into a copy
        of ``model``."""
        dev = next(model.parameters()).device
        restored = [load_checkpoint(p, map_location=dev)
                    for p in checkpoint_paths]
        _check_batch_stats(checkpoint_paths, restored)
        return cls.from_modules(
            [_load_state(copy.deepcopy(model), r) for r in restored], **kw)

    @classmethod
    def from_quantized(cls, model: nn.Module, paths: Sequence,
                       **kw) -> "EnsemblePredictor":
        """Build from K int8/int4 weight-only payloads
        (``core/quantize.save_quantized``, either package's); weights
        dequantize at load, compute stays f32."""
        restored = [load_quantized(p) for p in paths]
        _check_batch_stats(paths, restored)
        return cls.from_modules(
            [load_flax_variables(copy.deepcopy(model), r["params"],
                                 r.get("batch_stats")) for r in restored],
            **kw)

    def _logits(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """(K, n, C) member logits for any number of rows, on the device
        (all K members' on every rank with a plan: collective)."""
        out = []
        with torch.inference_mode():
            inputs = _served(inputs)
            for start in range(0, _rows(inputs), self.batch_size):
                chunk, m = _pad_chunk(inputs, start, self.batch_size)
                dev = self._to_device(chunk)
                if self._preprocess is not None:
                    dev = {**dev, **self._preprocess(dev)}
                out.append(self.net.member_logits(dev)[:, :m])
            return self.net.gather_members(torch.cat(out, dim=1))

    def calibrated(self, val_inputs: Dict[str, np.ndarray],
                   val_labels: np.ndarray,
                   weights: Optional[np.ndarray] = None
                   ) -> "EnsemblePredictor":
        """A new ``EnsemblePredictor`` with one temperature fitted on the
        stacked member logits (``report/calibration.
        fit_temperature_ensemble``), applied inside each member's
        softmax."""
        from multimodal_eeg_fmri_tpu_torch.report.calibration import (
            fit_temperature_ensemble,
        )

        t = float(fit_temperature_ensemble(
            self._logits(val_inputs), np.asarray(val_labels),
            weights=None if weights is None else np.asarray(weights)))
        params, buffers = self._whole_state()
        return EnsemblePredictor(
            self.model, params, buffers, plan=self._plan,
            batch_size=self.batch_size, preprocess=self._preprocess,
            reduce=self.reduce, temperature=t)

    def export_artifact(self, example: Dict[str, np.ndarray],
                        path: str | Path) -> Optional[bytes]:
        """``Predictor.export_artifact`` of the K-member forward; with a
        plan, collective: the members are gathered and global rank 0 writes
        the unplanned predictor's program (the other ranks return None)."""
        if self._plan is None:
            return super().export_artifact(example, path)
        params, buffers = self._whole_state()
        if world()[0] != 0:
            return None
        return EnsemblePredictor(
            self.model, params, buffers, batch_size=self.batch_size,
            preprocess=self._preprocess, reduce=self.reduce,
            temperature=self.temperature).export_artifact(example, path)

    def __call__(self, **inputs) -> np.ndarray:
        with annotate("mmef/predict"):
            outs = [probs[:, :m] if self.reduce == "none" else probs[:m]
                    for probs, m in self._outputs(inputs)]
            return np.concatenate(outs,
                                  axis=1 if self.reduce == "none" else 0)


def _check_batch_stats(paths: Sequence, restored: List[dict]) -> None:
    """Raise on a member set where some have BatchNorm statistics and some
    do not (the JAX package drops them all silently)."""
    has = [bool(r.get("batch_stats")) for r in restored]
    if any(has) and not all(has):
        lacking = [str(p) for p, h in zip(paths, has) if not h]
        raise ValueError(f"batch_stats missing from {lacking} but present "
                         f"in the other members' payloads")


class QueueFull(RuntimeError):
    """Raised on enqueue when the DynamicBatcher's bounded queue is full:
    a burst beyond the device's throughput reaches the caller instead of
    growing host memory and tail latency without bound."""


class _Request:
    __slots__ = ("inputs", "n", "event", "result", "error")

    def __init__(self, inputs, n):
        self.inputs = inputs
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None


class DynamicBatcher:
    """Coalesce concurrent small requests into one call of ``predictor``
    (a ``Predictor``, a reducing ``EnsemblePredictor``, or any
    ``fn(**inputs) -> array`` whose output leads with the batch axis),
    behind the same calling convention. A worker thread flushes the queue
    when ``max_batch`` rows wait or the oldest request has waited
    ``max_delay_ms``. Callers block only for their own rows; requests with
    different key sets are never mixed in one call.

    ``max_queue`` bounds the pending rows: an enqueue beyond it raises
    ``QueueFull`` at once. ``timeout_s`` bounds a caller's wait: a call that
    wedges gives ``TimeoutError``, and a request still queued then is
    withdrawn. ``rows / batches`` is the coalescing ratio.

    Over an ``EnsemblePredictor`` whose plan's mesh has process groups the
    batcher is collective, since each of the predictor's calls is: every
    rank of the mesh builds it with the same arguments, and it makes its
    own process group over the mesh's ranks for its broadcasts. Global rank
    0 is the front: it takes the requests under the contract above, and
    before each group's call it broadcasts the joined rows
    (``parallel.collectives.broadcast``), so that every rank makes the same
    call on the same rows in the same order; a group that cannot be joined
    goes back to its callers and is not broadcast; ``close()`` drains the
    queue and broadcasts a stop. On every other rank, a follower, a worker
    thread receives each batch, makes the same call, drops its result and
    counts ``batches`` and ``rows``; an error of that call is dropped there,
    since the front delivers the same error. A follower's ``__call__``
    raises; its ``close()`` waits for the front's stop. While a planned
    batcher is open no other thread may issue a collective on the plan's
    mesh. A follower that fails alone (a device fault) leaves the front's
    callers with ``TimeoutError`` after ``timeout_s``; the process group's
    timeout bounds the rest. A broadcast that fails stops the batcher on
    its rank: the waiting callers get its error, later calls raise, and
    ``close()`` raises it. A plan with no process group
    (``build_mesh(world_size=1)``) is served as an unplanned predictor."""

    FRONT = 0   # the global rank that takes the requests of a planned batcher

    def __init__(self, predictor: Callable, max_delay_ms: float = 5.0,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        if getattr(predictor, "reduce", None) == "none":
            raise ValueError(
                "EnsemblePredictor(reduce='none') returns (K, N, C): the "
                "batch axis is not leading, so per-request slicing would "
                "cut the member axis; wrap a reducing ensemble "
                "(reduce='mean_probs') instead")
        self.predictor = predictor
        self._delay = max_delay_ms / 1e3
        self._max = int(max_batch
                        or getattr(predictor, "batch_size", None) or 8)
        self._max_queue = None if max_queue is None else int(max_queue)
        self._timeout = timeout_s
        self.rejected = 0  # QueueFull rejections
        self._cv = threading.Condition()
        self._queue: list = []  # (enqueue_time, _Request)
        self._closed = False
        self._error: Optional[BaseException] = None  # a failed broadcast
        self.batches = 0  # calls of the predictor
        self.rows = 0     # rows served
        self._group = None
        plan = getattr(predictor, "_plan", None)
        # the world's group on a mesh with process groups; None on a
        # layout-only mesh of one rank (one of more raises there)
        if (plan is not None
                and plan.mesh.group(plan.mesh.axis_names) is not None):
            # collective over the world (the mesh's ranks): every rank
            # makes it, in one order
            self._group = dist.new_group(list(range(plan.mesh.ranks.size)))
        self._follower = (self._group is not None
                          and dist.get_rank() != self.FRONT)
        self._worker = threading.Thread(
            target=self._follow if self._follower else self._run,
            name="dynamic-batcher", daemon=True)
        self._worker.start()

    def __call__(self, **inputs) -> np.ndarray:
        """Enqueue one request (any row count) and block for its slice of
        the batched result."""
        if self._follower:
            raise RuntimeError(
                f"rank {dist.get_rank()} follows a planned DynamicBatcher: "
                f"its front, global rank {self.FRONT}, takes the requests")
        inputs = {k: np.asarray(v) for k, v in _served(inputs).items()}
        if not inputs:
            raise ValueError("empty request")
        req = _Request(inputs, len(next(iter(inputs.values()))))
        with self._cv:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed") from self._error
            if self._max_queue is not None:
                pending = sum(r.n for _, r in self._queue)
                if pending + req.n > self._max_queue:
                    self.rejected += 1
                    raise QueueFull(
                        f"DynamicBatcher queue full: {pending} rows pending "
                        f"(max_queue={self._max_queue}); request of {req.n} "
                        f"row(s) rejected; retry later or raise max_queue")
            self._queue.append((time.monotonic(), req))
            self._cv.notify_all()
        if not req.event.wait(self._timeout):
            # withdraw it if still queued; if already in flight its result
            # is dropped
            with self._cv:
                self._queue = [(t, r) for t, r in self._queue if r is not req]
            raise TimeoutError(
                f"DynamicBatcher request timed out after {self._timeout}s "
                f"(the call wedged or the server is overloaded)")
        if req.error is not None:
            raise req.error
        return req.result

    def _on_device(self) -> None:
        """A planned worker's collectives use the predictor's card: the
        current device is per thread."""
        device = getattr(self.predictor, "device", None)
        if (self._group is not None and device is not None
                and torch.device(device).type == "cuda"):
            torch.cuda.set_device(device)

    def _run(self):
        self._on_device()
        while True:
            with annotate("mmef/batcher/wait"), self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    break
                deadline = self._queue[0][0] + self._delay
                while (sum(r.n for _, r in self._queue) < self._max
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch, self._queue = self._queue, []
            with annotate("mmef/batcher/join"):
                groups: Dict[frozenset, list] = {}
                for _, r in batch:
                    groups.setdefault(frozenset(r.inputs), []).append(r)
            for reqs in groups.values():
                self._serve(reqs)
        if self._group is not None and self._error is None:
            try:
                self._send(None)
            except Exception:  # noqa: BLE001 -- kept: close() raises it
                pass

    def _serve(self, reqs: list) -> None:
        """One group's call; its result or error goes to its callers."""
        try:
            if self._error is not None:
                raise RuntimeError("DynamicBatcher is closed") from self._error
            with annotate("mmef/batcher/join"):
                joined = {
                    k: (np.concatenate([r.inputs[k] for r in reqs])
                        if len(reqs) > 1 else reqs[0].inputs[k])
                    for k in reqs[0].inputs
                }
                if self._group is not None:
                    joined = self._send(joined)
            out = np.asarray(self.predictor(**joined))
            self.batches += 1
            self.rows += sum(r.n for r in reqs)
            with annotate("mmef/batcher/deliver"):
                off = 0
                for r in reqs:
                    r.result = out[off:off + r.n]
                    off += r.n
        except Exception as e:  # deliver it; the worker goes on
            for r in reqs:
                r.error = e
        finally:
            with annotate("mmef/batcher/deliver"):
                for r in reqs:
                    r.event.set()

    def _send(self, joined: Optional[dict]) -> Optional[dict]:
        """Broadcast a batch (None: the stop) from the front. A broadcast
        that fails after its first message leaves the mesh out of step, so
        the batcher stops: the error goes to every queued caller too."""
        try:
            return broadcast(joined, self.FRONT, self._group)
        except TypeError:   # checked before anything was sent
            raise
        except Exception as e:
            with self._cv:
                self._error, self._closed = e, True
                pending, self._queue = self._queue, []
            for _, r in pending:
                r.error = e
                r.event.set()
            raise

    def _follow(self):
        """A follower's worker: each batch the front broadcasts, called
        here too, until the stop."""
        self._on_device()
        while True:
            try:
                joined = broadcast(None, self.FRONT, self._group)
            except Exception as e:  # no stop can come now: close() raises
                self._error = e
                return
            if joined is None:
                return
            try:
                self.predictor(**joined)
            except Exception:  # noqa: BLE001 -- the front delivers it
                continue
            self.batches += 1
            self.rows += len(next(iter(joined.values())))

    def close(self):
        """Drain the queue and stop the worker (idempotent). A planned
        front broadcasts the stop once the queue is drained; a follower
        waits for it. Raises the error of a broadcast that failed."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join()
        if self._error is not None:
            raise RuntimeError("the DynamicBatcher's broadcast failed"
                               ) from self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
