"""Meshes, collectives and per-rank input on ``torch.distributed``.
Counterpart of ``multimodal_eeg_fmri_tpu/parallel``: ``mesh`` lays the
ranks out on named axes with one process group per line of every set of
axes, and holds the sharding helpers (the JAX package's shardings as specs,
each rank's block of host arrays); ``collectives`` holds the
differentiable collectives over those axes, ``distributed`` the process
start-up (and a local world for tests and smoke runs), ``input`` each
rank's shard of host arrays and the gather of an ensemble axis's results,
``pipeline`` the stage axis, ``tensor``, ``fsdp`` and ``expert`` the
parameter layouts (on ``layout``'s machinery). The ensemble axis's callers
are ``train.cv.run_cv``, ``run_seed_sweep``, ``train.hpo.run_hpo`` (each
with ``mesh_plan=``), ``serving.EnsemblePredictor(plan=...)`` and a
``serving.DynamicBatcher`` over it (``collectives.broadcast`` hands it each
batch); ``mesh.ensemble_vmap`` maps a function over each rank's block of a
fold axis and gathers the blocks."""

from multimodal_eeg_fmri_tpu_torch.parallel.collectives import (
    all_gather,
    broadcast,
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
    gather_ensemble_tree,
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
    batch_sharded,
    batch_sharding,
    build_mesh,
    current_mesh,
    ensemble_batch_sharding,
    ensemble_sharding,
    ensemble_vmap,
    replicated,
    shard_batch,
    shard_ensemble_tree,
)
from multimodal_eeg_fmri_tpu_torch.parallel.tensor import (
    TPPlan,
    build_tp_mesh,
    shard_params_tp,
    tp_param_constraint,
    tp_param_specs,
)
from multimodal_eeg_fmri_tpu_torch.parallel.fsdp import (
    fsdp_param_constraint,
    fsdp_param_specs,
    shard_params_fsdp,
)
from multimodal_eeg_fmri_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    shard_stage_params,
)
from multimodal_eeg_fmri_tpu_torch.parallel.expert import (
    EPPlan,
    build_ep_mesh,
    ep_param_constraint,
    ep_param_specs,
    shard_params_ep,
)

__all__ = [
    "DATA_AXIS",
    "ENSEMBLE_AXIS",
    "EPPlan",
    "Mesh",
    "MeshPlan",
    "TPPlan",
    "all_gather",
    "batch_sharded",
    "batch_sharding",
    "broadcast",
    "build_ep_mesh",
    "build_hybrid_mesh",
    "build_mesh",
    "build_tp_mesh",
    "current_mesh",
    "ensemble_batch_sharding",
    "ensemble_sharding",
    "ensemble_vmap",
    "ep_param_constraint",
    "ep_param_specs",
    "fsdp_param_constraint",
    "fsdp_param_specs",
    "gather_ensemble_tree",
    "global_batch_tree",
    "global_ensemble_tree",
    "initialize_distributed",
    "pipeline_apply",
    "pmean",
    "pmean_grads",
    "ppermute_shift",
    "process_fold_range",
    "psum",
    "replicated",
    "reset_staged_bytes",
    "shard_batch",
    "shard_ensemble_tree",
    "shard_params_ep",
    "shard_params_fsdp",
    "shard_params_tp",
    "shard_sequence",
    "shard_stage_params",
    "spawn_local_world",
    "staged_bytes",
    "tp_param_constraint",
    "tp_param_specs",
]
