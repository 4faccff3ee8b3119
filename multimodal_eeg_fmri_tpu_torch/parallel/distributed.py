"""Process start-up and the multi-host mesh. Counterpart of
``multimodal_eeg_fmri_tpu/parallel/distributed.py``.

- ``initialize_distributed``: idempotent ``torch.distributed``
  initialisation from explicit arguments or the launcher's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; a no-op returning 1
  in a single process.
- ``build_hybrid_mesh``: a 2D (ensemble, data) mesh whose ensemble axis
  spans hosts and whose data axis stays inside one host, so that the
  per-step data-parallel all-reduce never crosses hosts while independent
  ensemble members (folds, trials) do. Ranks are numbered host by host, as
  launchers number them (``ranks_per_host`` consecutive ranks a host).
- ``spawn_local_world``: ``n`` processes on this host, started with
  ``spawn``, each with one torch thread, joined in a process group through a
  file store in a private directory (no port to collide on), running
  ``fn(rank, world_size, *args)``; returns each rank's result. It is the
  port's counterpart of the JAX tests' 8-device virtual mesh: the tests and
  ``chip_smoke.py`` start their worlds with it.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    MeshPlan,
    mesh_sizes,
    world,
)

logger = logging.getLogger(__name__)

# how long a collective waits for its peers before the group fails
TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> int:
    """Join the default process group (idempotent) and return the world
    size. ``coordinator_address`` is ``host:port`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``), ``process_id`` this rank (default ``RANK``); a world of
    one joins nothing. ``backend`` defaults to NCCL where CUDA is available,
    else gloo; an NCCL rank takes the card ``LOCAL_RANK`` (default its rank)
    modulo the cards it sees."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return 1
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=TIMEOUT)
    logger.info("torch.distributed initialized (%s): rank %d/%d", backend,
                process_id, num_processes)
    return num_processes


def build_hybrid_mesh(ensemble: int = 0, data: int = 0,
                      ranks_per_host: Optional[int] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None) -> MeshPlan:
    """A 2D (ensemble, data) mesh spanning hosts. ``ensemble`` and ``data``
    are global sizes (0 infers one, as ``build_mesh``); ``ranks_per_host``
    defaults to ``LOCAL_WORLD_SIZE``, else the whole world (one host). Each
    row of the data axis lies inside one host; the ensemble axis spans the
    hosts in blocks of ``ensemble / hosts`` members."""
    n = world()[1] if world_size is None else world_size
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % ranks_per_host:
        raise ValueError(f"{n} ranks are not whole hosts of {ranks_per_host}")
    hosts = n // ranks_per_host
    ensemble, data = mesh_sizes(n, ensemble, data)
    if hosts > 1 and ranks_per_host % data:
        raise ValueError(
            f"data axis ({data}) must divide one host's rank count "
            f"({ranks_per_host}) so the data-parallel all-reduce stays "
            "inside a host")
    # ranks are numbered host by host, so rows of ``data`` consecutive ranks
    # fill one host before the next, and the ensemble axis (ensemble =
    # hosts · ranks_per_host / data) spans the hosts evenly
    return MeshPlan(Mesh(np.arange(n).reshape(ensemble, data),
                         (ENSEMBLE_AXIS, DATA_AXIS), rank=rank))


def _world_worker(rank: int, fn: Callable, world_size: int, backend: str,
                  root: str, args: tuple) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{root}/store", world_size=world_size,
        rank=rank, timeout=TIMEOUT)
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, Path(root) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_local_world(fn: Callable, world_size: int, *args,
                      backend: str = "gloo") -> List:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in a ``backend`` process group; returns their results
    by rank (each saved with ``torch.save``). ``fn`` must be importable
    (a module-level function). A rank that raises fails the call, and the
    other ranks are stopped."""
    with tempfile.TemporaryDirectory(prefix="mmef_world_") as root:
        mp.start_processes(_world_worker,
                           args=(fn, world_size, backend, root, args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
