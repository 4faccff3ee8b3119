"""The persistent kernel cache (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/core/cache.py``.

The JAX package compiles its programs with XLA and keeps them in XLA's
persistent compilation cache. The port compiles one thing: the library of
hand-written CUDA kernels that ``ops/_kernels.py`` builds with ``nvcc`` at
first use (a minute or more for the tensor-core kernels). Its file name
carries a hash of the sources, the flags and the toolkit's nvcc version, so
a directory kept across runs, or shared by processes, loads the library
that an earlier process built, and builds anew only for changed sources or
another toolkit; a process with no nvcc loads the one library there built
from these sources. The programs themselves need no cache: PyTorch runs them
eagerly, and a traced program is kept by ``core/aot.py``.
"""

from __future__ import annotations

import os
from typing import Optional

# the counterpart of JAX_COMPILATION_CACHE_DIR
CACHE_DIR_ENV = "MULTIMODAL_EEG_FMRI_TPU_TORCH_CACHE_DIR"


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Idempotently fix the directory the kernel library is built into and
    loaded from, and return it: ``cache_dir``, else the directory in
    ``$MULTIMODAL_EEG_FMRI_TPU_TORCH_CACHE_DIR``, else the one already in
    force (``build/kernels/`` beside the package). The first call fixes it;
    a call after the library is loaded keeps the loaded library and returns
    the directory it came from."""
    from multimodal_eeg_fmri_tpu_torch.ops import _kernels

    chosen = cache_dir or os.environ.get(CACHE_DIR_ENV)
    return str(_kernels.use_build_dir(chosen))
