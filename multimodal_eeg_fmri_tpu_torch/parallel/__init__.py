"""Meshes, collectives and per-rank input on ``torch.distributed``.
Counterpart of ``multimodal_eeg_fmri_tpu/parallel``: ``mesh`` lays the
ranks out on named axes with one process group per axis line,
``collectives`` holds the differentiable collectives over those axes,
``distributed`` the process start-up (and a local world for tests and
smoke runs), ``input`` each rank's shard of host arrays.

Not ported yet (ROADMAP.md, queue A): the pipeline (item 7a), tensor,
FSDP and expert parallelism (item 7b), and ``ensemble_vmap`` with the
ensemble and data axes' callers (item 7c, item 8)."""

from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    all_gather,
    pmean,
    pmean_grads,
    ppermute_shift,
    psum,
    reset_staged_bytes,
    staged_bytes,
)
from multimodal_eeg_fmri_tpu_torch.parallel.distributed import (
    build_hybrid_mesh,
    initialize_distributed,
    spawn_local_world,
)
from multimodal_eeg_fmri_tpu_torch.parallel.input import (
    global_batch_tree,
    global_ensemble_tree,
    process_fold_range,
    shard_sequence,
)
from multimodal_eeg_fmri_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    MeshPlan,
    build_mesh,
    current_mesh,
)

__all__ = [
    "DATA_AXIS",
    "ENSEMBLE_AXIS",
    "Mesh",
    "MeshPlan",
    "all_gather",
    "build_hybrid_mesh",
    "build_mesh",
    "current_mesh",
    "global_batch_tree",
    "global_ensemble_tree",
    "initialize_distributed",
    "pmean",
    "pmean_grads",
    "ppermute_shift",
    "process_fold_range",
    "psum",
    "reset_staged_bytes",
    "shard_sequence",
    "spawn_local_world",
    "staged_bytes",
]
