"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` at first use, one
process per source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library
goes to ``build/kernels/`` beside the package and its file name carries a hash
of the sources and flags, so a changed source builds anew and an unchanged
one is loaded as it is. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmef_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of any that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless a library for exactly them exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build under a private directory, then rename: concurrent builders
    # never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [src for src in _sources() if src.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in units]
        _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
              for obj, src in zip(objs, units)])
        lib = str(Path(tmp) / out.name)
        _run([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    # q, k, v, O, lse, B, H, Tq, Tk, D, is_bf16, bf16_ops, scale
    lib.mmef_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [
        f, ctypes.POINTER(ctypes.c_int64), p]
    lib.mmef_flash_fwd.restype = i
    strides = ctypes.POINTER(ctypes.c_int64)
    # q, k, v, dO, lse, delta, dK, dV, B, H, Tq, Tk, D, is_bf16, bf16_ops,
    # scale
    lib.mmef_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [f, strides, p]
    lib.mmef_flash_bwd_dkv.restype = i
    # q, k, v, dO, lse, delta, dQ, B, H, Tq, Tk, D, is_bf16, bf16_ops, scale
    lib.mmef_flash_bwd_dq.argtypes = [p] * 7 + [i] * 7 + [f, strides, p]
    lib.mmef_flash_bwd_dq.restype = i
    # the kernels past head dim 128 take the same arguments as the
    # tensor-core ones up to 128: up to 256 the split kernels
    # (flash_fwd_split.cu, flash_bwd_split.cu), past it K1 on the CUDA cores
    # (flash_wide.cu) and K2, K3 on the tensor cores (flash_bwd_deep.cu)
    for name in ("mmef_flash_fwd_split", "mmef_flash_bwd_dkv_split",
                 "mmef_flash_bwd_dq_split", "mmef_flash_fwd_wide",
                 "mmef_flash_bwd_dkv_deep", "mmef_flash_bwd_dq_deep"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(lib, name.rsplit("_", 1)[0]).argtypes
        fn.restype = i
    # x, y, zi, zf, coeffs (host), carry, scratch, G, S, T, M, L, stream
    lib.mmef_sosfilt.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.mmef_sosfilt.restype = i
    return lib
