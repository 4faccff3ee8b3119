"""ctypes binding of the native host-IO library (``native/fastio.cpp``),
the port's own. Counterpart of ``multimodal_eeg_fmri_tpu/data/native_io.py``,
copied: the same entry points, the same ABI check (version 2) and the same
numpy fallbacks.

It gives the loaders a parallel mmap'd ingest path for the reference's
many-small-file layout (one file per subject × feature type,
``fMRI_CODE/run_fmri_v11.py:81-155``). On first use it builds the shared
library with the repo's Makefile into ``native/build/`` when a C++ toolchain
is present (in a private directory, then renamed into place, so that
concurrent builds never load a half-written library); every entry point
degrades to the numpy path when it is not, so the port has no hard native
dependency. This is host I/O, not the device path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

# Must match fio_abi_version() in native/fastio.cpp. Bumped on any exported
# signature change; a stale .so built from older source is rebuilt (or
# refused) instead of being called through mismatched argtypes — calling
# e.g. the old stride-by-value fio_read_mat_batch with the new offsets
# pointer would scribble float32 data at pointer-valued strides.
_ABI_VERSION = 2


def _native_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "native"


def _needs_build(so: Path) -> bool:
    if not so.exists():
        return True
    src = _native_dir() / "fastio.cpp"
    try:
        return src.stat().st_mtime > so.stat().st_mtime
    except OSError:
        return False


def _build(so: Path) -> ctypes.CDLL:
    """``make -B -C native`` into a private directory under
    ``native/build/``; the library is loaded from there, then renamed to
    ``so``, so that no other process's half-written file is ever loaded."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        subprocess.run(
            ["make", "-B", "-C", str(_native_dir()), f"BUILD={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        built = Path(tmp) / so.name
        lib = ctypes.CDLL(str(built))
        os.replace(built, so)
    return lib


def _load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _native_dir() / "build" / "libfastio.so"
    lib = None
    if _needs_build(so):
        try:
            lib = _build(so)
        except (subprocess.SubprocessError, OSError) as e:
            if not so.exists():
                logger.info(
                    "native fastio unavailable (%s); using numpy path", e)
                return None
            # stale .so + no toolchain: fall through and let the ABI check
            # decide whether the existing library is still safe to use.
    try:
        lib = lib or ctypes.CDLL(str(so))
        try:
            lib.fio_abi_version.restype = ctypes.c_int64
            abi = int(lib.fio_abi_version())
        except AttributeError:
            abi = -1  # pre-versioning build
        if abi != _ABI_VERSION:
            # dlopen caches the mapping in-process, so a rebuild now can't
            # safely replace the already-loaded image — refuse it instead.
            logger.warning(
                "libfastio.so ABI %d != expected %d (stale build at %s); "
                "using the numpy path. Run `make -B -C native` and "
                "restart to re-enable the native ingest.", abi,
                _ABI_VERSION, so)
            return None
        lib.fio_read_f32.restype = ctypes.c_int64
        lib.fio_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.fio_read_csv.restype = ctypes.c_int64
        lib.fio_read_csv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.fio_read_csv_batch.restype = ctypes.c_int64
        lib.fio_read_csv_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int]
        lib.fio_read_mat.restype = ctypes.c_int64
        lib.fio_read_mat.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.fio_read_mat_batch.restype = ctypes.c_int64
        lib.fio_read_mat_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _LIB = lib
    except OSError as e:
        logger.info("failed to load libfastio (%s); using numpy path", e)
    return _LIB


def native_available() -> bool:
    return _load_library() is not None


def read_csv_f32(path: str | Path, max_elems: int = 1 << 22,
                 skip_header: int = 1) -> Optional[np.ndarray]:
    """One CSV → (rows, cols) float32 array, NaN→0. ``skip_header``:
    1 = pandas semantics (row 0 is always the header — the framework's
    feature-CSV convention), 0 = auto-detect, -1 = never skip.
    Returns None on failure (the caller falls back to the ``csv`` module)."""
    lib = _load_library()
    if lib is None:
        return _numpy_csv(path, skip_header)
    arena = np.empty(max_elems, np.float32)
    cols = ctypes.c_int64(0)
    rows = lib.fio_read_csv(
        str(path).encode(), arena.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), max_elems,
        ctypes.byref(cols), skip_header)
    if rows < 0 or cols.value <= 0:
        return None
    return arena[: rows * cols.value].reshape(rows, cols.value).copy()


def read_csv_batch(
    paths: Sequence[str | Path],
    max_elems_per_file: int = 1 << 20,
    n_threads: int = 8,
    skip_header: int = 1,
) -> List[Optional[np.ndarray]]:
    """Parse many CSVs in parallel into one arena; per-file arrays or None."""
    lib = _load_library()
    if lib is None:
        return [_numpy_csv(p, skip_header) for p in paths]
    n = len(paths)
    # Size the arena from the actual files: a CSV float field occupies at
    # least 2 bytes (digit + separator), so bytes/2 bounds the element
    # count. An oversized arena is not just waste — first-touch page
    # faults on hundreds of idle MB dominated ingest time on small hosts.
    try:
        max_bytes = max(Path(p).stat().st_size for p in paths)
        stride = min(max_elems_per_file, max(1024, max_bytes // 2 + 16))
    except OSError:
        stride = max_elems_per_file
    max_elems_per_file = stride
    arena = np.empty(n * max_elems_per_file, np.float32)
    rows = np.zeros(n, np.int64)
    cols = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.fio_read_csv_batch(
        c_paths, n,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems_per_file,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads, skip_header,
    )
    out: List[Optional[np.ndarray]] = []
    for i in range(n):
        if rows[i] <= 0 or cols[i] <= 0:
            out.append(None)
        else:
            k = int(rows[i] * cols[i])
            out.append(
                arena[i * max_elems_per_file: i * max_elems_per_file + k]
                .reshape(int(rows[i]), int(cols[i])).copy())
    return out


def read_f32_binary(path: str | Path,
                    max_elems: int = 1 << 24) -> Optional[np.ndarray]:
    lib = _load_library()
    if lib is None:
        try:
            return np.fromfile(str(path), dtype=np.float32)
        except OSError:
            return None
    arena = np.empty(max_elems, np.float32)
    n = lib.fio_read_f32(
        str(path).encode(),
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_elems)
    if n < 0:
        return None
    return arena[:n].copy()


_MAT_MAX_DIMS = 8


def read_mat_f32(path: str | Path,
                 max_elems: int = 1 << 22) -> Optional[np.ndarray]:
    """First variable of a classic MAT v5 file as float32 (MATLAB shape,
    NaN→0) — the native form of ``loaders._first_mat_array``. Returns None
    whenever the native parser declines (library missing, v7.3/HDF5 file,
    big-endian, sparse/struct/cell/complex first variable, arena overflow);
    the caller falls back to scipy (or h5py), so coverage never narrows."""
    lib = _load_library()
    if lib is None:
        return None
    arena = np.empty(max_elems, np.float32)
    dims = np.zeros(_MAT_MAX_DIMS, np.int64)
    ndims = ctypes.c_int64(0)
    n = lib.fio_read_mat(
        str(path).encode(),
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_elems,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _MAT_MAX_DIMS,
        ctypes.byref(ndims))
    if n < 0:
        return None
    shape = tuple(int(d) for d in dims[: ndims.value])
    return arena[:n].reshape(shape, order="F").copy()


def read_mat_batch(
    paths: Sequence[str | Path],
    max_elems_per_file: int = 1 << 20,
    n_threads: int = 8,
) -> List[Optional[np.ndarray]]:
    """Parse many MAT v5 files on the native thread pool; per-file arrays
    (MATLAB shape, float32, NaN→0) or None where the parser declined."""
    if not paths:
        return []
    lib = _load_library()
    if lib is None:
        return [None] * len(paths)
    n = len(paths)
    # Size each file's arena slice from ITS OWN byte count (idle arena
    # pages cost more than parsing on this host — a single big file among
    # thousands of small ones must not inflate every slice). Worst case
    # per file: int8 storage (1 byte/element) under miCOMPRESSED with the
    # 8x byte-expansion budget → 8 * file_bytes ELEMENTS; real EEG
    # features sit at 2-6x. Beyond-budget files overflow their slice and
    # fall back to the per-file path (correct, just not batched).
    def _cap(p) -> int:
        try:
            size = Path(p).stat().st_size
        except OSError:
            return max_elems_per_file
        return min(max_elems_per_file, max(1024, 8 * size + 64))

    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([_cap(p) for p in paths], out=offsets[1:])
    arena = np.empty(int(offsets[-1]), np.float32)
    elems = np.zeros(n, np.int64)
    dims = np.zeros(n * _MAT_MAX_DIMS, np.int64)
    ndims = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.fio_read_mat_batch(
        c_paths, n,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        elems.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _MAT_MAX_DIMS,
        ndims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads)
    out: List[Optional[np.ndarray]] = []
    for i in range(n):
        if elems[i] < 0:
            out.append(None)
            continue
        shape = tuple(
            int(d) for d in dims[i * _MAT_MAX_DIMS:
                                 i * _MAT_MAX_DIMS + int(ndims[i])])
        lo = int(offsets[i])
        out.append(arena[lo: lo + int(elems[i])]
                   .reshape(shape, order="F").copy())
    return out


def _numpy_csv(path, skip_header: int = 1) -> Optional[np.ndarray]:
    """The numpy path of ``read_csv_f32``, with its ``skip_header``: row 0
    skipped if 1, if it reads as no number if 0, never if -1. (The JAX
    package's fallback always guesses, so there a header of numeric column
    names, as pandas writes for an unnamed frame, becomes a data row.)"""
    def read(skip):
        return np.genfromtxt(str(path), delimiter=",", skip_header=skip,
                             dtype=np.float32, ndmin=2)

    try:
        arr = read(1 if skip_header == 1 else 0)
        if skip_header == 0 and arr.size and np.isnan(arr[0]).all():
            arr = read(1)   # the header row became NaNs
        if arr.size == 0:
            return None
        return np.nan_to_num(arr, nan=0.0)
    except (OSError, ValueError):
        return None
