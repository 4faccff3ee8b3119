"""Raw-recording → tri-modal feature pathway (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/data/raw.py``: the ERP, PW and CONN feature tensors
computed on the device from raw continuous EEG, so that raw recordings and
precomputed files converge on the same dataset dicts:

raw (N, T, C) @ fs →
  broadband: epoch → mean over epochs (ERP (epoch_len, C))
  spectrogram: STFT power → per-band power over time (PW)
  conn band: zero-phase SOS band-pass (two S1 launches) → epoch → Hilbert →
    PLV/COH/WPLI upper-triangle features (CONN)
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor, model_device
from multimodal_eeg_fmri_tpu_torch.ops import signal as S

DEFAULT_BANDS = {"delta": (1.0, 4.0), "theta": (4.0, 8.0),
                 "alpha": (8.0, 13.0), "beta": (13.0, 30.0),
                 "gamma": (30.0, 45.0)}


def _epochs(x: torch.Tensor, epoch_len: int) -> torch.Tensor:
    """(N, T, C) → (N, n_epochs, epoch_len, C), a strided view."""
    return torch.movedim(S.epoch_signal(torch.movedim(x, 1, 0), epoch_len),
                         2, 0)


def make_raw_eeg_featurizer(
    fs: float = 250.0,
    epoch_len: int = 250,
    bands: Optional[Mapping[str, Tuple[float, float]]] = None,
    conn_band: str = "alpha",
    nperseg: int = 128,
    filter_order: int = 4,
    device="cuda",
):
    """Build ``featurize(raw (N, T, C)) -> {'erp', 'pw', 'conn'}`` on
    ``device`` (the card unless the caller asks for the CPU). The filter
    design runs once, here, on the host.

    - erp: (N, epoch_len, C) epoch-averaged broadband waveform
    - pw:  (N, frames, C·n_bands) band-power time series (channels-last)
    - conn: (N, 3·C(C,2)) PLV/COH/WPLI of the ``conn_band``-limited signal
    """
    device = model_device(device)
    bands = dict(bands or DEFAULT_BANDS)
    sos, zi = S.butter_bandpass_sos(*bands[conn_band], fs, filter_order)
    # the device's copies of the host tables, made once: a copy per call
    # would synchronise the host with the card
    zi = torch.as_tensor(zi, dtype=torch.float32, device=device)
    freqs = torch.as_tensor(S.rfft_freqs(nperseg, fs), dtype=torch.float32,
                            device=device)

    def featurize(raw) -> Dict[str, torch.Tensor]:
        raw = as_tensor(raw, device, torch.float32)
        N = raw.shape[0]
        erp = _epochs(raw, epoch_len).mean(dim=1)

        spec = S.spectrogram_power(raw.transpose(-1, -2), nperseg=nperseg,
                                   noverlap=nperseg // 2)    # (N, C, F, frames)
        bp = S.band_power(spec, freqs, bands)                # (N, C, B, frames)
        pw = bp.reshape(N, -1, bp.shape[-1]).transpose(1, 2)

        banded = torch.movedim(S.sosfiltfilt(sos, torch.movedim(raw, 1, 0),
                                             zi), 0, 1)
        conn = S.connectivity_features(_epochs(banded, epoch_len))
        return {"erp": erp, "pw": pw, "conn": conn}

    return featurize


def raw_recordings_to_dataset(
    raw: np.ndarray,          # (N, T, C) continuous recordings
    labels: np.ndarray,       # (N,)
    subjects: Optional[np.ndarray] = None,
    device="cuda",
    **featurizer_kwargs,
) -> Dict[str, np.ndarray]:
    """One call: raw batch → training-ready tri-modal dataset dict of numpy
    arrays, featurized on ``device``."""
    featurize = make_raw_eeg_featurizer(device=device, **featurizer_kwargs)
    out = {k: v.cpu().numpy() for k, v in featurize(raw).items()}
    out["label"] = np.asarray(labels, np.int32)
    out["subject"] = (np.asarray(subjects, np.int32) if subjects is not None
                      else np.arange(1, len(labels) + 1, dtype=np.int32))
    return out
