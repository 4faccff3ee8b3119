"""Online (streaming) raw-EEG featurization for continuous monitoring
(PyTorch). Counterpart of ``multimodal_eeg_fmri_tpu/data/streaming.py``.

``data/raw.py`` is offline: whole recordings arrive at once and are
zero-phase filtered, which needs future samples. A bedside deployment sees an
endless stream of small chunks instead. This module is the causal
counterpart: fixed-size chunks go through ``step``, whose state carries the
biquad filter state of every band and a rolling epoch buffer, and which
emits the feature triple (the epoch's ERP waveform, band powers, PLV/COH/WPLI
connectivity) each time an epoch boundary completes.

- One S1 launch per step filters the chunk through all bands: the bands are
  the groups of one grouped ``sosfilt_series`` call, and the state
  (n_bands, S, 2, C) is S1's grouped state layout.
- Carried filter state makes chunking invisible: the band signals equal one
  causal ``sosfilt`` over the whole stream.
- ``step`` computes the features on every chunk and sets ``ready`` where an
  epoch has just completed, as the JAX package's scan does, so that a
  replayed session stacks the same entries.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.data.arrays import as_tensor, model_device
from multimodal_eeg_fmri_tpu_torch.data.raw import DEFAULT_BANDS
from multimodal_eeg_fmri_tpu_torch.ops import signal as S


class StreamState(NamedTuple):
    """State of the streaming featurizer (one recording / channel set)."""

    zi: torch.Tensor          # (n_bands, S, 2, C) causal filter states
    buf_raw: torch.Tensor     # (epoch_len, C) broadband epoch buffer
    buf_band: torch.Tensor    # (n_bands, epoch_len, C) band-limited buffers
    fill: int                 # samples buffered towards the next epoch
    epoch_idx: int            # completed epochs so far


def make_streaming_featurizer(
    fs: float = 250.0,
    epoch_len: int = 250,
    chunk_len: int = 50,
    bands: Optional[Mapping[str, Tuple[float, float]]] = None,
    conn_band: str = "alpha",
    nperseg: int = 128,
    filter_order: int = 4,
    device="cuda",
):
    """Build ``(init, step)`` for online featurization on ``device`` (the
    card unless the caller asks for the CPU).

    - ``init(n_channels) -> StreamState``
    - ``step(state, chunk (chunk_len, C)) -> (state, out)`` with ``out =
      {"ready", "erp", "pw", "conn"}``; when ``ready`` is True the features
      describe the just-completed epoch: erp (epoch_len, C) waveform, pw
      (frames, C·n_bands) band power, conn (3·C(C,2),) connectivity of
      ``conn_band``.

    ``chunk_len`` must divide ``epoch_len`` (a fixed emission schedule).
    """
    if epoch_len % chunk_len:
        raise ValueError(
            f"chunk_len ({chunk_len}) must divide epoch_len ({epoch_len})")
    device = model_device(device)
    bands = dict(bands or DEFAULT_BANDS)
    if conn_band not in bands:
        raise ValueError(f"conn_band {conn_band!r} not in {sorted(bands)}")
    n_bands = len(bands)
    conn_i = list(bands).index(conn_band)
    coeffs = S.sos_coefficients(np.stack([
        S.butter_bandpass_sos(lo, hi, fs, filter_order)[0]
        for lo, hi in bands.values()]))                      # (n_bands, S, 6)
    n_sections = coeffs.shape[1]
    freqs = torch.as_tensor(S.rfft_freqs(nperseg, fs), dtype=torch.float32,
                            device=device)

    def init(n_channels: int) -> StreamState:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return StreamState(
            zi=zeros(n_bands, n_sections, 2, n_channels),
            buf_raw=zeros(epoch_len, n_channels),
            buf_band=zeros(n_bands, epoch_len, n_channels),
            fill=0, epoch_idx=0)

    def step(state: StreamState, chunk):
        chunk = as_tensor(chunk, device, torch.float32)
        C = chunk.shape[1]
        # every band's causal filter in one launch, state carried
        y, zf = S.sosfilt_series(coeffs, chunk.repeat(1, n_bands), state.zi,
                                 return_zf=True)
        new_band = y.view(chunk_len, n_bands, C).transpose(0, 1)
        buf_band = torch.cat([state.buf_band[:, chunk_len:], new_band], dim=1)
        buf_raw = torch.cat([state.buf_raw[chunk_len:], chunk])
        fill = state.fill + chunk_len
        ready = fill >= epoch_len

        # features of the (possibly just-completed) buffered epoch
        spec = S.spectrogram_power(buf_raw.T[None], nperseg=nperseg,
                                   noverlap=nperseg // 2)     # (1, C, F, fr)
        bp = S.band_power(spec, freqs, bands)                 # (1, C, B, fr)
        pw = bp[0].reshape(-1, bp.shape[-1]).T                # (fr, C·B)
        conn = S.connectivity_features(buf_band[conn_i][None])
        out = {"ready": ready, "erp": buf_raw, "pw": pw, "conn": conn}
        return StreamState(
            zi=zf, buf_raw=buf_raw, buf_band=buf_band,
            fill=fill - epoch_len if ready else fill,
            epoch_idx=state.epoch_idx + int(ready)), out

    return init, step


def stream_session(raw, chunk_len: int, init, step) -> Dict[str, torch.Tensor]:
    """Replay a recorded (T, C) session, T a multiple of ``chunk_len``,
    through the online path chunk by chunk. Returns the per-chunk outputs
    stacked ("ready" a bool tensor on the host); epochs are the entries
    where ``out["ready"]`` is True."""
    T, C = raw.shape
    if T % chunk_len:
        raise ValueError(f"T ({T}) must be a multiple of chunk_len")
    state = init(C)
    outs = []
    for k in range(0, T, chunk_len):
        state, out = step(state, raw[k:k + chunk_len])
        outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs])
               for k in ("erp", "pw", "conn")}
    stacked["ready"] = torch.tensor([o["ready"] for o in outs])
    return stacked
