"""Where a run may read and write, and what it may not load.

The port's compile caches live in fixed directories under
``portbench/.cache/`` inside the checkout, so that only the first run of a
cell in a checkout builds the kernel library, and every later run loads it.
The directories are fixed paths: a directory made from a temporary name, a
process id or the time would never hit.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List, Mapping

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"

# environment variable -> directory under the checkout
CACHE_DIRS = {
    # the port's kernel library (core/cache.py:enable_compilation_cache)
    "MULTIMODAL_EEG_FMRI_TPU_TORCH_CACHE_DIR": CACHE / "kernels",
    "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
    "TRITON_CACHE_DIR": CACHE / "triton",
}

# top-level module names no process of the benchmark may load: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_eeg_fmri_tpu")


def fix_caches(environ=os.environ) -> dict:
    """Point every compile cache at its directory under the checkout (made
    if missing) and return the mapping."""
    for var, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        environ[var] = str(path)
    # a library that would load JAX by itself is kept from doing so
    environ["USE_FLAX"] = "0"
    environ["USE_JAX"] = "0"
    return {var: environ[var] for var in CACHE_DIRS}


def top_level(names: Iterable[str]) -> set:
    """The top-level package of each module name: the part before the
    first dot, whole (``multimodal_eeg_fmri_tpu_torch`` is not
    ``multimodal_eeg_fmri_tpu``)."""
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules: Mapping = None) -> List[str]:
    """The forbidden top-level packages present in ``modules``
    (``sys.modules`` by default)."""
    loaded = top_level(sys.modules if modules is None else modules)
    return sorted(loaded & set(FORBIDDEN))
