"""Configuration, seeds, logging, checkpoints, quantized payloads,
profiling, the determinism harness, the kernel cache and the program
bundles of the port."""

from multimodal_eeg_fmri_tpu_torch.core.aot import export_jitted, load_bundle
from multimodal_eeg_fmri_tpu_torch.core.cache import enable_compilation_cache

from multimodal_eeg_fmri_tpu_torch.core.checkpoint import (
    export_frozen_encoder,
    find_best_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_eeg_fmri_tpu_torch.core.config import (
    BridgeConfig,
    EEGConfig,
    ExperimentConfig,
    FMRIConfig,
    MeshConfig,
    TrainConfig,
    load_config,
    save_config,
)
from multimodal_eeg_fmri_tpu_torch.core.determinism import (
    run_twice_and_compare,
)
from multimodal_eeg_fmri_tpu_torch.core.logging import (
    MetricsLogger,
    get_logger,
)
from multimodal_eeg_fmri_tpu_torch.core.profiling import (
    StepTimer,
    annotate,
    trace,
)
from multimodal_eeg_fmri_tpu_torch.core.quantize import (
    load_quantized,
    save_quantized,
)
from multimodal_eeg_fmri_tpu_torch.core.rng import (
    RngStream,
    fold_in,
    seed_everything,
    training_key,
)

__all__ = ["BridgeConfig", "EEGConfig", "ExperimentConfig", "FMRIConfig",
           "MeshConfig", "MetricsLogger", "RngStream", "StepTimer",
           "TrainConfig", "annotate", "enable_compilation_cache",
           "export_frozen_encoder", "export_jitted", "find_best_checkpoint",
           "fold_in", "get_logger", "load_bundle", "load_checkpoint",
           "load_config", "load_quantized", "run_twice_and_compare",
           "save_checkpoint", "save_config", "save_quantized",
           "seed_everything", "trace", "training_key"]
