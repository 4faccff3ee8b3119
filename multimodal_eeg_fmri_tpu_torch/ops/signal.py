"""Signal processing on the device (PyTorch). Counterpart of
``multimodal_eeg_fmri_tpu/ops/signal.py``: filter design on the host with
scipy, the filtering, spectra, analytic signal, PLV/COH/WPLI connectivity
and the fMRI ROI reductions on tensors, channels-last, batched over leading
dimensions.

The biquad cascade ``sosfilt`` is the one recurrence on the path. On a CUDA
tensor it launches S1 (``csrc/sosfilt.cu``, built by ``ops/_kernels.py``) or
raises; on a CPU tensor it runs ``sosfilt_plain``, the same recurrence as a
loop over time, operation for operation. S1 runs as a chunked time-parallel
scan on the chunk length ``sosfilt_schedule`` picks (sequential for short
signals); ``sosfilt_chunked_plain`` is that schedule in plain PyTorch, the
version the card holds the kernel to bit for bit. S1 counts its launches in
``sosfilt_cuda.launches``; ``kernel_launches()`` reads it. Nothing
differentiates through the filter (raw signals carry no gradient), and
``sosfilt`` raises on an input that requires one.

Where PyTorch's defaults differ from the JAX package's (x64 off), this module
follows JAX: standard deviations are population ones (``correction=0``), the
filter coefficients are rounded to float32, and the Hilbert multiplier and
the frequency bins, float64 host tables in JAX, are float32. Tables are
built on the device or passed as device tensors where a call would
otherwise copy them from the host, which synchronises the host with the
card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

CUDA_ERROR_INVALID_VALUE = 1   # cudaErrorInvalidValue


# ---------------------------------------------------------------------------
# Filter design (host, scipy)
# ---------------------------------------------------------------------------

def butter_bandpass(low: float, high: float, fs: float, order: int = 4):
    """Host-side Butterworth band-pass design (scipy). Returns (b, a, zi)
    as float64 numpy arrays; zi is the lfilter_zi steady-state template."""
    from scipy.signal import butter, lfilter_zi

    b, a = butter(order, [low, high], btype="bandpass", fs=fs)
    zi = lfilter_zi(b, a)
    return (np.asarray(b, np.float64), np.asarray(a, np.float64),
            np.asarray(zi, np.float64))


def butter_bandpass_sos(low: float, high: float, fs: float, order: int = 4):
    """Host-side Butterworth design in cascaded second-order sections, the
    form that is stable in float32. Returns (sos (S,6), zi (S,2))."""
    from scipy.signal import butter, sosfilt_zi

    sos = butter(order, [low, high], btype="bandpass", fs=fs, output="sos")
    zi = sosfilt_zi(sos)
    return np.asarray(sos, np.float64), np.asarray(zi, np.float64)


# ---------------------------------------------------------------------------
# Transfer-function filtering: float64 CPU oracles, not on the device path
# ---------------------------------------------------------------------------

def lfilter(b, a, x: torch.Tensor, zi=None) -> torch.Tensor:
    """Direct-form-II-transposed IIR filter along axis 0 of ``x`` (T, ...)
    in float64, returned in x's dtype; matches ``scipy.signal.lfilter``.
    ``zi`` is None (zeros), the (n-1,) template, or the full (n-1, ...)
    state. A parity oracle: the expanded transfer function of a high-order
    band-pass is unstable in float32, so the device path is ``sosfiltfilt``."""
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    b, a = (b / a[0]).tolist(), (a / a[0]).tolist()
    n = len(b)
    xt = x.to(torch.float64)
    state_shape = (n - 1,) + tuple(xt.shape[1:])
    if zi is None:
        z = torch.zeros(state_shape, dtype=torch.float64, device=x.device)
    else:
        zi = torch.as_tensor(zi, dtype=torch.float64, device=x.device)
        z = (zi.reshape((n - 1,) + (1,) * (xt.dim() - 1)).expand(state_shape)
             if zi.dim() == 1 else zi)
    z = list(z)
    ys = []
    for xk in xt:
        yk = b[0] * xk + z[0]
        z = [b[i] * xk - a[i] * yk + (z[i] if i < n - 1 else 0.0)
             for i in range(1, n)]
        ys.append(yk)
    return torch.stack(ys).to(x.dtype)


def _odd_extend(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """scipy's odd extension of axis 0 by ``padlen`` samples at each end."""
    front = 2 * x[:1] - x[1:padlen + 1].flip(0)
    back = 2 * x[-1:] - x[-padlen - 1:-1].flip(0)
    return torch.cat([front, x, back], dim=0)


def filtfilt(b, a, x: torch.Tensor, zi, padlen: Optional[int] = None
             ) -> torch.Tensor:
    """Zero-phase forward-backward ``lfilter`` along axis 0, matching
    ``scipy.signal.filtfilt`` defaults (odd padding, padlen =
    3·max(len(a), len(b)), steady-state initial conditions)."""
    n = max(len(b), len(a))
    if padlen is None:
        padlen = 3 * n
    T = x.shape[0]
    if T <= padlen:
        raise ValueError(f"input length {T} must exceed padlen {padlen}")
    ext = _odd_extend(x, padlen)
    zi = torch.as_tensor(np.asarray(zi), dtype=torch.float64, device=x.device)
    zi_shaped = zi.reshape((zi.shape[0],) + (1,) * (x.dim() - 1))
    y = lfilter(b, a, ext, zi=zi_shaped * ext[0][None])
    y = y.flip(0)
    y = lfilter(b, a, y, zi=zi_shaped * y[0][None])
    return y.flip(0)[padlen:padlen + T]


# ---------------------------------------------------------------------------
# Second-order sections: S1 and its plain version
# ---------------------------------------------------------------------------

def sos_coefficients(sos) -> np.ndarray:
    """The (..., S, 6) section table as float32, as JAX rounds the Python
    float coefficients against a float32 signal."""
    return np.ascontiguousarray(np.asarray(sos), dtype=np.float32)


def sosfilt_plain(coeffs: np.ndarray, x: torch.Tensor,
                  zi: Optional[torch.Tensor] = None):
    """S1's recurrence in plain PyTorch: (y (T, M), zf (G, S, 2, M/G)).

    ``x`` is a time-major (T, M) float32 signal whose M series fall in G
    equal groups, series m in group m // (M/G); ``coeffs`` (G, S, 6) holds
    each group's cascade (b0 b1 b2 a0 a1 a2, a0 unused, as scipy normalises
    it to 1); ``zi`` (G, S, 2, M/G) is the state (zeros if None). Each step
    and section computes, rounding each operation to float32 as JAX's scan
    body does: out = b0·y + z0; z0 ← b1·y − a1·out + z1; z1 ← b2·y − a2·out;
    y ← out."""
    G, S, _ = coeffs.shape
    T, M = x.shape
    Mg = M // G
    c = torch.as_tensor(coeffs, device=x.device)[..., None]   # (G, S, 6, 1)
    b0, b1, b2, a1, a2 = (c[:, :, i] for i in (0, 1, 2, 4, 5))  # (G, S, 1)
    if zi is None:
        zi = torch.zeros((G, S, 2, Mg), dtype=x.dtype, device=x.device)
    z0 = [zi[:, s, 0] for s in range(S)]
    z1 = [zi[:, s, 1] for s in range(S)]
    ys = []
    for xk in x.view(T, G, Mg):
        yk = xk
        for s in range(S):
            out = b0[:, s] * yk + z0[s]
            z0[s] = b1[:, s] * yk - a1[:, s] * out + z1[s]
            z1[s] = b2[:, s] * yk - a2[:, s] * out
            yk = out
        ys.append(yk)
    y = (torch.stack(ys) if ys else x.new_empty((0, G, Mg))).reshape(T, M)
    zf = torch.stack([torch.stack([z0[s], z1[s]], dim=1) for s in range(S)],
                     dim=1)
    return y, zf


def sosfilt_carry_matrix(coeffs: np.ndarray, L: int) -> np.ndarray:
    """A^L (G, 2S, 2S) float64: L zero-input steps of each group's cascade,
    acting on the state (z0, z1 of section 0, z0, z1 of section 1, ...), the
    float32 coefficients taken exactly. A is the step applied to the unit
    vectors with x = 0, raised to the L-th power by repeated squaring. It is
    block lower triangular: a section's state never reaches an earlier
    section."""
    G, S, _ = coeffs.shape
    eye = np.broadcast_to(np.eye(2 * S), (G, 2 * S, 2 * S))
    base = _zero_input_steps(coeffs, eye, 1)
    power = None
    while L:
        if L & 1:
            power = base if power is None else power @ base
        base = base @ base
        L >>= 1
    return power


def _zero_input_steps(coeffs: np.ndarray, z: np.ndarray, n: int
                      ) -> np.ndarray:
    """``n`` steps of each group's cascade with x = 0, in float64, on the
    states z (G, 2S, K) (K states per group, one per column)."""
    c = np.asarray(coeffs, np.float64)[..., None]               # (G, S, 6, 1)
    for _ in range(n):
        z, y = z.copy(), 0.0
        for s in range(c.shape[1]):
            b0, b1, b2, _, a1, a2 = (c[:, s, i] for i in range(6))
            out = b0 * y + z[:, 2 * s]
            z0 = b1 * y - a1 * out + z[:, 2 * s + 1]
            z[:, 2 * s + 1] = b2 * y - a2 * out
            z[:, 2 * s] = z0
            y = out
    return z


@functools.lru_cache(maxsize=32)
def _carry_matrix_on(table: bytes, shape: tuple, L: int,
                     device: torch.device) -> torch.Tensor:
    """``sosfilt_carry_matrix`` on ``device``, kept per coefficient set, L and
    device: the host-to-card copy synchronises, so it is made once."""
    coeffs = np.frombuffer(table, np.float32).reshape(shape)
    return torch.as_tensor(sosfilt_carry_matrix(coeffs, L), device=device)


def _carry_matrix(coeffs: np.ndarray, L: int, device) -> torch.Tensor:
    """A^L of ``coeffs`` on ``device``, from the cache."""
    return _carry_matrix_on(coeffs.tobytes(), coeffs.shape, L,
                            torch.device(device))


# sosfilt_schedule's cost model, in SM clock cycles of the H100 (1.98 GHz),
# fitted to S1's device time at chunk lengths 16-256 and its host time per
# call by CUDA events (chip_smoke.py prints both beside the rule's choice)
SOS_TILE = 16               # time steps per register tile of S1
SOS_STEP_CYCLES = 100       # one step of one series' cascade, its chain
SOS_CARRY_CYCLES = 370      # one chunk of the f64 carry
SOS_LAUNCH_CYCLES = 30000   # the chunked call's extra host time (~15 us)
SOS_SCHEDULERS = 132 * 4    # warp schedulers of the card's 132 SMs


@functools.lru_cache(maxsize=256)
def sosfilt_schedule(T: int, M: int, G: int, S: int) -> int:
    """S1's chunk length L for T steps of M series in G groups of S
    sections: L >= T is the sequential schedule (one thread per series),
    else a multiple of the 16-step tile. It takes the L of least modelled
    time: a pass over L steps costs L chain steps, or more once its threads
    outnumber what the card's schedulers overlap (a step issues 9·S + 2
    instructions a warp, so each scheduler hides a chain step behind
    STEP/(9·S + 2) warps); the chunked schedule adds its two passes, C − 1
    carry steps and the host time of two more launches and a scratch
    allocation. Short signals, whose chain is shorter than that host time,
    and series that fill the card on their own stay sequential. G does not
    enter the model: groups share the kernels."""
    overlap = SOS_SCHEDULERS * 32 * SOS_STEP_CYCLES / (9 * S + 2)

    def passes(steps: int, threads: int) -> float:
        return steps * SOS_STEP_CYCLES * max(1.0, threads / overlap)

    best, best_cost = T, passes(T, M)
    for L in range(SOS_TILE, T, SOS_TILE):
        C = -(-T // L)
        cost = (passes(L, M * (C - 1)) + passes(L, M * C)
                + (C - 1) * SOS_CARRY_CYCLES + SOS_LAUNCH_CYCLES)
        if cost < best_cost:
            best, best_cost = L, cost
    return best


def _chunk_length(chunk, T: int, M: int, G: int, S: int) -> int:
    """The chunk length to run: the rule's if ``chunk`` is None, else
    ``chunk``, which must be a positive int and a multiple of the 16-step
    tile unless it is >= T (the sequential schedule)."""
    if chunk is None:
        return sosfilt_schedule(T, M, G, S)
    if (not isinstance(chunk, int) or isinstance(chunk, bool) or chunk < 1
            or (chunk < T and chunk % SOS_TILE)):
        raise ValueError(f"chunk must be a positive multiple of {SOS_TILE} "
                         f"or >= T={T}, got {chunk!r}")
    return chunk


def sosfilt_chunked_plain(coeffs: np.ndarray, x: torch.Tensor,
                          zi: Optional[torch.Tensor] = None, chunk=None):
    """S1's chunked schedule in plain PyTorch: (y (T, M), zf (G, S, 2,
    M/G)), the arguments of ``sosfilt_plain`` and the chunk length (None:
    ``sosfilt_schedule``'s). The three phases of ``csrc/sosfilt.cu``,
    vectorised over series × chunks: the whole chunks from zero states,
    keeping their end states e_c; the carry s_{c+1} = A^L·s_c + e_c in
    float64, written out elementwise in the kernel's order (row i adds the
    two products of each section's columns, sums those pairs over the
    sections up to its own in order, then adds e_c), each start state
    rounded to float32; each chunk again from its start state.
    With chunk >= T it is ``sosfilt_plain``. Tests and ``chip_smoke.py``
    hold the kernel to it; the CPU route is ``sosfilt_plain``."""
    G, S, _ = coeffs.shape
    T, M = x.shape
    Mg, N = M // G, 2 * S
    L = _chunk_length(chunk, T, M, G, S)
    C = -(-T // L)
    if zi is None:
        zi = torch.zeros((G, S, 2, Mg), dtype=x.dtype, device=x.device)
    if C == 1:
        return sosfilt_plain(coeffs, x, zi)
    full = (C - 1) * L

    def by_chunk(t):   # (full, M) -> (L, G·(C−1)·Mg): groups stay whole
        return t.reshape(C - 1, L, G, Mg).permute(1, 2, 0, 3).reshape(L, -1)

    _, e = sosfilt_plain(coeffs, by_chunk(x[:full]))
    e = e.reshape(G, N, C - 1, Mg).double()
    p = _carry_matrix(coeffs, L, x.device)
    s = zi.reshape(G, N, Mg).double()
    starts = [zi]
    for c in range(C - 1):
        # (G, 2S rows, S sections, Mg): each section's two products, added
        pair = (p[:, :, 0::2, None] * s[:, None, 0::2]
                + p[:, :, 1::2, None] * s[:, None, 1::2])
        acc = pair[:, :, 0]
        for q in range(1, S):    # rows of sections q and later
            acc[:, 2 * q:] = acc[:, 2 * q:] + pair[:, 2 * q:, q]
        s = acc + e[:, :, c]
        starts.append(s.float().reshape(G, S, 2, Mg))
    z = torch.stack(starts[:-1], dim=3).reshape(G, S, 2, -1)
    y, _ = sosfilt_plain(coeffs, by_chunk(x[:full]), z)
    y = y.reshape(L, G, C - 1, Mg).permute(2, 0, 1, 3).reshape(full, M)
    y_last, zf = sosfilt_plain(coeffs, x[full:], starts[-1])
    return torch.cat([y, y_last]), zf


def _check_sosfilt_inputs(coeffs: np.ndarray, x: torch.Tensor,
                          zi: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"sosfilt_cuda takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (T, M) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (coeffs.dtype != np.float32 or coeffs.ndim != 3
            or coeffs.shape[2] != 6 or not coeffs.flags.c_contiguous):
        raise ValueError(f"coeffs must be a contiguous float32 (G, S, 6) "
                         f"array, got {coeffs.dtype} {coeffs.shape}")
    G, S, _ = coeffs.shape
    T, M = x.shape
    if T < 1 or M < 1 or M % G or M > 2**31 - 1:
        raise ValueError(f"x of shape {(T, M)} does not split into {G} "
                         "equal non-empty groups")
    if zi is not None and (zi.dtype != torch.float32
                           or zi.shape != (G, S, 2, M // G)
                           or zi.device != x.device
                           or not zi.is_contiguous()):
        raise ValueError(f"zi must be a contiguous float32 {(G, S, 2, M // G)}"
                         f" tensor on {x.device}, got {zi.dtype} "
                         f"{tuple(zi.shape)} on {zi.device}")
    return G, S, M


def sosfilt_cuda(coeffs: np.ndarray, x: torch.Tensor,
                 zi: Optional[torch.Tensor] = None, return_zf: bool = False,
                 chunk=None):
    """Launch S1: y (T, M), and zf (G, S, 2, M/G) if ``return_zf``; the
    arguments are those of ``sosfilt_plain``, and ``chunk`` the chunk length
    (None: ``sosfilt_schedule``'s; >= T: the sequential schedule). One call
    dispatches three kernels on the chunked schedule, one on the sequential
    one, and counts one launch. Raises on anything the kernel does not take;
    does not synchronise."""
    G, S, M = _check_sosfilt_inputs(coeffs, x, zi)
    T = x.shape[0]
    L = min(_chunk_length(chunk, T, M, G, S), T)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    y = torch.empty_like(x)
    zf = (torch.empty((G, S, 2, M // G), dtype=x.dtype, device=x.device)
          if return_zf else None)
    carry = scratch = None
    if L < T:
        carry = _carry_matrix(coeffs, L, x.device)
        scratch = torch.empty((-(-T // L) - 1, 2 * S, M), dtype=x.dtype,
                              device=x.device)
    err = library().mmef_sosfilt(
        x.data_ptr(), y.data_ptr(), None if zi is None else zi.data_ptr(),
        None if zf is None else zf.data_ptr(),
        coeffs.ctypes.data_as(ctypes.c_void_p),
        None if carry is None else carry.data_ptr(),
        None if scratch is None else scratch.data_ptr(), G, S, T, M, L,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"S1 refused G={G} groups of S={S} sections over "
                         f"{tuple(x.shape)} in chunks of {L}: its limits are "
                         "those that mmef_sosfilt (csrc/sosfilt.cu) checks")
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: cudaError {err}")
    sosfilt_cuda.launches += 1
    return (y, zf) if return_zf else y


def kernel_launches() -> dict:
    """S1's launches since the count was last reset: {"sosfilt": n}."""
    return {"sosfilt": sosfilt_cuda.launches}


def reset_kernel_launches() -> None:
    sosfilt_cuda.launches = 0


reset_kernel_launches()


def sosfilt_series(coeffs: np.ndarray, x: torch.Tensor,
                   zi: Optional[torch.Tensor] = None,
                   return_zf: bool = False):
    """S1 on a CUDA tensor, its plain version on a CPU tensor; arguments as
    ``sosfilt_plain`` (``coeffs`` from ``sos_coefficients``)."""
    if x.requires_grad:
        raise ValueError("sosfilt is not differentiable: S1 has no backward "
                         "(raw signals carry no gradient); detach the input")
    if x.device.type == "cpu":
        y, zf = sosfilt_plain(coeffs, x, zi)
        return (y, zf) if return_zf else y
    return sosfilt_cuda(coeffs, x, zi, return_zf)


def sosfilt(sos, x: torch.Tensor, zi=None, return_zf: bool = False):
    """Cascaded biquad filtering along axis 0 of ``x`` (T, ...), matching
    ``scipy.signal.sosfilt``. ``sos`` is a host (S, 6) array; ``zi`` is None
    (zeros), the (S, 2) template or the full (S, 2, ...) state.
    ``return_zf=True`` also returns the final state (y, zf), so that a
    caller can continue the same filter on the next chunk."""
    coeffs = sos_coefficients(sos)[None]                       # (1, S, 6)
    S_ = coeffs.shape[1]
    T, rest = x.shape[0], tuple(x.shape[1:])
    M = math.prod(rest)
    xt = x.to(torch.float32).reshape(T, M).contiguous()
    z = None
    if zi is not None:
        zi = torch.as_tensor(zi, dtype=torch.float32, device=x.device)
        if zi.dim() == 2:  # (S, 2) template
            zi = zi.reshape(S_, 2, 1).expand(S_, 2, M)
        z = zi.reshape(1, S_, 2, M).contiguous()
    out = sosfilt_series(coeffs, xt, z, return_zf)
    if not return_zf:
        return out.reshape(T, *rest).to(x.dtype)
    y, zf = out
    return y.reshape(T, *rest).to(x.dtype), zf.reshape(S_, 2, *rest)


def sosfiltfilt(sos, x: torch.Tensor, zi, padlen: Optional[int] = None
                ) -> torch.Tensor:
    """Zero-phase forward-backward biquad-cascade filtering along axis 0,
    matching ``scipy.signal.sosfiltfilt`` defaults: odd padding, each pass
    started from the steady-state ``zi`` (S, 2) scaled by its first sample.
    Two S1 launches on a CUDA tensor. ``zi`` may be a host array or a
    tensor; one already on x's device spares a synchronising copy."""
    sos = np.asarray(sos)
    if padlen is None:
        ntaps = 2 * sos.shape[0] + 1
        ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        padlen = 3 * int(ntaps)
    T = x.shape[0]
    if T <= padlen:
        raise ValueError(f"input length {T} must exceed padlen {padlen}")
    ext = _odd_extend(x, padlen)
    zi_shaped = torch.as_tensor(zi, dtype=x.dtype, device=x.device).reshape(
        (sos.shape[0], 2) + (1,) * (x.dim() - 1))
    y = sosfilt(sos, ext, zi=zi_shaped * ext[0][None, None])
    y = y.flip(0)
    y = sosfilt(sos, y, zi=zi_shaped * y[0][None, None])
    return y.flip(0)[padlen:padlen + T]


def bandpass_filtfilt(x: torch.Tensor, low: float, high: float, fs: float,
                      order: int = 4) -> torch.Tensor:
    """Zero-phase Butterworth band-pass over the time axis of a batched
    (..., T, C) tensor, as a cascade of second-order sections."""
    sos, zi = butter_bandpass_sos(low, high, fs, order)
    y = sosfiltfilt(sos, torch.movedim(x, -2, 0), zi)
    return torch.movedim(y, 0, -2)


# ---------------------------------------------------------------------------
# Spectral: frame / STFT / spectrogram / band power
# ---------------------------------------------------------------------------

def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Slide windows over the time axis (first axis): (T, ...) →
    (n_frames, frame_len, ...), n_frames = 1 + (T − frame_len)//hop. A
    strided view."""
    return torch.movedim(x.unfold(0, frame_len, hop), -1, 1)


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (scipy.signal.stft default), computed in f32."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return (0.5 * (1.0 - torch.cos(2.0 * math.pi * k / n))).to(dtype)


def stft(x: torch.Tensor, nperseg: int = 256, noverlap: Optional[int] = None,
         window: Optional[torch.Tensor] = None, scale: bool = True
         ) -> torch.Tensor:
    """Short-time Fourier transform of (..., T), time last, matching
    ``scipy.signal.stft`` with ``boundary=None, padded=False``: returns
    (..., freq, frames) complex."""
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    if window is None:
        window = hann_window(nperseg, device=x.device)
    frames = x.unfold(-1, nperseg, hop) * window      # (..., frames, nperseg)
    spec = torch.fft.rfft(frames, dim=-1)              # (..., frames, freq)
    if scale:
        spec = spec / window.sum()                     # scipy 'spectrum' mode
    return torch.movedim(spec, -1, -2)


def spectrogram_power(x: torch.Tensor, nperseg: int = 256,
                      noverlap: Optional[int] = None) -> torch.Tensor:
    """Power spectrogram |STFT|², (..., freq, frames) float32."""
    s = stft(x, nperseg, noverlap)
    return (s.real ** 2 + s.imag ** 2).to(torch.float32)


def band_power(spec_power: torch.Tensor, freqs,
               bands: Dict[str, Tuple[float, float]]) -> torch.Tensor:
    """Average power per band of (..., freq, frames) → (..., n_bands,
    frames). ``freqs`` (freq,) are the bin centres in Hz, as float32."""
    freqs = torch.as_tensor(freqs, dtype=torch.float32,
                            device=spec_power.device)
    outs = []
    for lo, hi in bands.values():
        mask = ((freqs >= lo) & (freqs < hi)).to(spec_power.dtype)
        denom = mask.sum().clamp_min(1.0)
        outs.append(torch.einsum("...ft,f->...t", spec_power, mask) / denom)
    return torch.stack(outs, dim=-2)


def rfft_freqs(nperseg: int, fs: float) -> np.ndarray:
    return np.fft.rfftfreq(nperseg, 1.0 / fs)


# ---------------------------------------------------------------------------
# Resampling (Fourier method, scipy.signal.resample parity)
# ---------------------------------------------------------------------------

def resample(x: torch.Tensor, num: int, axis: int = -1) -> torch.Tensor:
    """FFT-domain resampling identical to ``scipy.signal.resample`` for real
    inputs: copy min(num, T)//2+1 low-frequency bins, with scipy's
    Nyquist-bin scaling (×2 when downsampling past it, ×½ when upsampling
    splits it), then inverse-rFFT at the new length."""
    ax = axis % x.dim()
    T = x.shape[ax]
    X = torch.fft.rfft(x, dim=ax)
    n_out = num // 2 + 1
    N = min(num, T)
    Y = X.narrow(ax, 0, min(N // 2 + 1, n_out))
    if N % 2 == 0:
        head = Y.narrow(ax, 0, N // 2)
        ny = Y.narrow(ax, N // 2, 1)
        tail = Y.narrow(ax, N // 2 + 1, Y.shape[ax] - N // 2 - 1)
        if num < T:
            ny = ny * 2.0
        elif num > T:
            ny = ny * 0.5
        Y = torch.cat([head, ny, tail], dim=ax)
    pad = n_out - Y.shape[ax]
    if pad > 0:
        shape = list(Y.shape)
        shape[ax] = pad
        Y = torch.cat([Y, Y.new_zeros(shape)], dim=ax)
    y = torch.fft.irfft(Y, n=num, dim=ax)
    return (y * (num / T)).to(x.dtype)


# ---------------------------------------------------------------------------
# Normalization / epoching
# ---------------------------------------------------------------------------

def zscore(x: torch.Tensor, axis=None, eps: float = 1e-8) -> torch.Tensor:
    """(x − mean) / (population std + eps) over ``axis`` (all if None)."""
    dims = tuple(range(x.dim())) if axis is None else axis
    mu = x.mean(dim=dims, keepdim=True)
    sd = x.std(dim=dims, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def epoch_signal(x: torch.Tensor, epoch_len: int, hop: Optional[int] = None):
    """Cut a continuous (T, C) recording into (n_epochs, epoch_len, C)."""
    return frame_signal(x, epoch_len, hop or epoch_len)


# ---------------------------------------------------------------------------
# Analytic signal + connectivity (PLV / COH / WPLI)
# ---------------------------------------------------------------------------

def hilbert_analytic(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Analytic signal via the FFT method (``scipy.signal.hilbert``),
    complex64."""
    ax = axis % x.dim()
    T = x.shape[ax]
    X = torch.fft.fft(x.to(torch.float32), dim=ax)
    # built on the device: a host table would cost a synchronising copy
    h = torch.zeros(T, dtype=torch.float32, device=x.device)
    if T % 2 == 0:
        h[0] = h[T // 2] = 1
        h[1:T // 2] = 2
    else:
        h[0] = 1
        h[1:(T + 1) // 2] = 2
    shape = [1] * x.dim()
    shape[ax] = T
    return torch.fft.ifft(X * h.reshape(shape), dim=ax)


def _gram(z: torch.Tensor) -> torch.Tensor:
    """Σ_t z_tc·conj(z_td) / n over the last-but-one axis: (..., C, C)."""
    return torch.einsum("...tc,...td->...cd", z, z.conj()) / z.shape[-2]


def plv_matrix(analytic: torch.Tensor) -> torch.Tensor:
    """Phase-locking value over epochs and time of (..., E, T, C) complex:
    PLV_ij = |mean exp(i(φ_i − φ_j))|, one complex Gram product."""
    phase = analytic / analytic.abs().clamp_min(1e-12)
    return _gram(phase.reshape(*phase.shape[:-3], -1, phase.shape[-1])).abs()


def coherence_matrix(analytic: torch.Tensor) -> torch.Tensor:
    """|S_ij| / sqrt(S_ii S_jj), cross-spectra averaged over epochs and
    time of the analytic signal."""
    S = _gram(analytic.reshape(*analytic.shape[:-3], -1, analytic.shape[-1]))
    p = torch.diagonal(S, dim1=-2, dim2=-1).real
    denom = torch.sqrt(p[..., :, None] * p[..., None, :])
    return S.abs() / denom.clamp_min(1e-12)


def wpli_matrix(analytic: torch.Tensor) -> torch.Tensor:
    """Weighted phase-lag index |E[Im S_ij]| / E[|Im S_ij|] over epochs ×
    time."""
    z = analytic.reshape(*analytic.shape[:-3], -1, analytic.shape[-1])
    cross_im = (torch.einsum("...tc,...td->...tcd", z.imag, z.real)
                - torch.einsum("...tc,...td->...tcd", z.real, z.imag))
    num = cross_im.mean(dim=-3).abs()
    den = cross_im.abs().mean(dim=-3)
    return num / den.clamp_min(1e-12)


_CONNECTIVITY = {"plv": plv_matrix, "coh": coherence_matrix,
                 "wpli": wpli_matrix}


def connectivity_features(x: torch.Tensor,
                          metrics: Sequence[str] = ("plv", "coh", "wpli")
                          ) -> torch.Tensor:
    """Upper-triangle connectivity vector of an epoched band-limited
    (..., E, T, C) signal, concatenated per metric: the 459-d CONN layout
    (3 metrics × C(18,2) pairs)."""
    analytic = hilbert_analytic(x, axis=-2)
    iu, ju = torch.triu_indices(x.shape[-1], x.shape[-1], 1, device=x.device)
    return torch.cat([_CONNECTIVITY[m](analytic)[..., iu, ju]
                      for m in metrics], dim=-1)


def connectivity_matrices(x: torch.Tensor,
                          metrics: Sequence[str] = ("plv", "coh", "wpli")
                          ) -> torch.Tensor:
    """(..., C, C, M) stacked matrices: the GNN encoder's input format."""
    analytic = hilbert_analytic(x, axis=-2)
    return torch.stack([_CONNECTIVITY[m](analytic) for m in metrics], dim=-1)


# ---------------------------------------------------------------------------
# fMRI: volume normalization + ROI time-series reduction
# ---------------------------------------------------------------------------

def normalize_volumes(vols: torch.Tensor, axis=(-3, -2, -1),
                      eps: float = 1e-8) -> torch.Tensor:
    """Per-volume z-scoring of 4D (..., T, X, Y, Z) BOLD data."""
    return zscore(vols, axis=axis, eps=eps)


def roi_onehot(roi_labels: np.ndarray, n_rois: int) -> np.ndarray:
    """(V,) voxel→ROI labels (0 = background) → (V, R) membership matrix
    normalised per ROI, so ROI means become one matmul (host numpy)."""
    onehot = (roi_labels[:, None] == np.arange(1, n_rois + 1)[None, :]
              ).astype(np.float32)
    return onehot / np.maximum(onehot.sum(axis=0, keepdims=True), 1.0)


def roi_timeseries(vols_flat: torch.Tensor, membership: torch.Tensor
                   ) -> torch.Tensor:
    """ROI mean time series (..., T, V) · (V, R) → (..., T, R)."""
    return torch.matmul(vols_flat, membership)


def roi_aggregate(ts: torch.Tensor, method: str = "both") -> torch.Tensor:
    """Aggregate ROI time series (..., T, R) over time: mean, population
    std, or both concatenated."""
    if method == "mean":
        return ts.mean(dim=-2)
    if method == "std":
        return ts.std(dim=-2, correction=0)
    if method == "both":
        return torch.cat([ts.mean(dim=-2), ts.std(dim=-2, correction=0)],
                         dim=-1)
    raise ValueError(f"unknown agg method {method!r}")
