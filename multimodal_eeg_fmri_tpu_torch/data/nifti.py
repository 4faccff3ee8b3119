"""Minimal NIfTI-1 volume I/O and the fMRI volume → features pipeline
(PyTorch). Counterpart of ``multimodal_eeg_fmri_tpu/data/nifti.py``.

The host half is a copy of the JAX package's: a reader and writer for the
subset that matters (single-file ``.nii``/``.nii.gz``, scalar dtypes,
scl_slope/scl_inter scaling, Fortran voxel order), since nibabel is not a
dependency. ``volumes_to_roi_features`` then runs the device half:
per-volume z-scoring → ROI membership matmul → mean/std aggregation, the
activation-feature vectors the reference loads from
``subject_N_activation_{type}.csv``. The (V, R) membership matrix is built
on the device from the int labels, so only V·4 bytes of labels cross to it.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device
from multimodal_eeg_fmri_tpu_torch.ops.signal import roi_aggregate, zscore

# NIfTI-1 datatype codes → numpy dtypes (the common scalar subset)
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_nifti(path: str | Path) -> Tuple[np.ndarray, Dict]:
    """Read a .nii / .nii.gz volume → (data, header dict).

    Data comes back as float32 with scl_slope/scl_inter applied, shaped
    (X, Y, Z[, T]) in Fortran voxel order like nibabel's get_fdata.
    """
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    byteorder = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        byteorder = ">"

    dim = struct.unpack_from(f"{byteorder}8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from(f"{byteorder}h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    scl_slope = struct.unpack_from(f"{byteorder}f", raw, 112)[0]
    scl_inter = struct.unpack_from(f"{byteorder}f", raw, 116)[0]
    vox_offset = int(struct.unpack_from(f"{byteorder}f", raw, 108)[0])
    magic = raw[344:348]
    if not magic.startswith((b"n+1", b"ni1")):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(byteorder)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=vox_offset or 352)
    data = data.reshape(shape, order="F").astype(np.float32)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    header = {"shape": shape, "datatype": datatype,
              "scl_slope": scl_slope, "scl_inter": scl_inter}
    return data, header


def write_nifti(path: str | Path, data: np.ndarray) -> Path:
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz)."""
    path = Path(path)
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + data.tobytes(order="F")
    if path.suffix == ".gz":
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        path.write_bytes(payload)
    return path


def volumes_to_roi_features(
    bold: np.ndarray,        # (X, Y, Z, T) or (T, X, Y, Z) BOLD series
    atlas: np.ndarray,       # (X, Y, Z) integer ROI labels, 0 = background
    n_rois: Optional[int] = None,
    agg_method: str = "both",
    time_last: bool = True,
    device="cuda",
) -> np.ndarray:
    """Device pipeline on ``device`` (the card unless the caller asks for
    the CPU): normalize volumes → ROI mean time series (one-hot matmul) →
    mean/std aggregation. Returns the activation feature vector (numpy)."""
    device = model_device(device)
    bold = np.asarray(bold, np.float32)
    if time_last:
        bold = np.moveaxis(bold, -1, 0)  # → (T, X, Y, Z)
    T = bold.shape[0]
    flat = torch.as_tensor(bold.reshape(T, -1)).to(device)
    labels = np.asarray(atlas).reshape(-1).astype(np.int32)
    n_rois = n_rois or int(labels.max())
    labels = torch.as_tensor(labels).to(device)
    return _roi_pipeline(flat, labels, n_rois, agg_method).cpu().numpy()


def _roi_pipeline(flat: torch.Tensor, labels: torch.Tensor, n_rois: int,
                  agg_method: str = "both") -> torch.Tensor:
    """flat (T, V) BOLD and (V,) int labels → the aggregated ROI features,
    on the tensors' device."""
    rois = torch.arange(1, n_rois + 1, dtype=labels.dtype,
                        device=labels.device)
    onehot = (labels[:, None] == rois[None, :]).to(torch.float32)   # (V, R)
    membership = onehot / onehot.sum(dim=0).clamp_min(1.0)
    x = zscore(flat, axis=-1)                                       # per volume
    return roi_aggregate(x @ membership, agg_method)  # over (T, R) means


def load_subject_volume_features(
    nii_path: str | Path,
    atlas_path: str | Path,
    agg_method: str = "both",
    device="cuda",
) -> np.ndarray:
    """One subject: BOLD NIfTI + atlas NIfTI → activation feature vector."""
    bold, _ = read_nifti(nii_path)
    atlas, _ = read_nifti(atlas_path)
    return volumes_to_roi_features(bold, atlas.astype(np.int32),
                                   agg_method=agg_method, device=device)
