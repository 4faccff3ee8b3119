"""The port's ``ops/signal.py`` against the JAX package's, on the same numpy
inputs from a seed.

The port's ``sosfilt`` runs here on CPU tensors, so it takes S1's plain
version (the card test of S1 itself is in ``test_torch_port_kernel.py``).
Tolerances, each with its reason:

- filter design: equal (the same scipy calls);
- ``lfilter``/``filtfilt``, float64 oracles on both sides (JAX under
  ``enable_x64``): 1e-8 absolute at |y| ≲ 1, since the expanded 8th-order
  transfer function amplifies f64 rounding: each side lies ~2e-9 from
  scipy;
- the f32 biquad cascade (``sosfilt``, ``sosfiltfilt``, ``bandpass_filtfilt``):
  1e-5 of the largest |y|, since the poles near the unit circle carry each
  f32 rounding a long way: each side lies up to ~4e-6·max|y| from scipy's
  f64 result, and they part where XLA fuses or reorders; chunked with the
  carried state against one shot: equal;
- FFT-based functions (``stft``, ``spectrogram_power``, ``band_power``,
  ``resample``, ``hilbert_analytic``) and the PLV/COH/WPLI Gram products:
  1e-5 relative and 1e-6 absolute, f32 transforms and sums in another
  order; the Hann window: 1e-7 (f32 cosines from two libraries); framing,
  epoching and the ROI membership: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.ops import signal as J
from multimodal_eeg_fmri_tpu_torch.ops import signal as P

FS = 250.0
BANDS = {"alpha": (8.0, 13.0), "beta": (13.0, 30.0), "gamma": (30.0, 45.0)}
F32_FILTER_RTOL = 1e-5   # of the largest |y|


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _close_filtered(got, want):
    """max |got − want| ≤ F32_FILTER_RTOL · max |want|."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=F32_FILTER_RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def sig():
    """(T, C) = (600, 4) f32: noise plus a 10 Hz rhythm."""
    r = np.random.default_rng(0)
    t = np.arange(600) / FS
    x = r.standard_normal((600, 4)) + np.sin(2 * np.pi * 10 * t)[:, None]
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def alpha():
    return J.butter_bandpass_sos(8.0, 13.0, FS, 4)


def test_filter_design_is_the_jax_packages():
    for got, want in zip(P.butter_bandpass(8, 13, FS, 4),
                         J.butter_bandpass(8, 13, FS, 4)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(P.butter_bandpass_sos(1, 4, FS, 3),
                         J.butter_bandpass_sos(1, 4, FS, 3)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.rfft_freqs(128, FS), J.rfft_freqs(128, FS))


@pytest.mark.parametrize("case", ["lfilter", "lfilter_zi", "filtfilt"])
def test_f64_oracles_match_jax_x64(sig, case):
    b, a, zi = J.butter_bandpass(8, 13, FS, 4)
    x = sig.astype(np.float64)
    with jax.enable_x64():
        if case == "filtfilt":
            want = J.filtfilt(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x),
                              jnp.asarray(zi))
        else:
            z = jnp.asarray(zi) if case == "lfilter_zi" else None
            want = J.lfilter(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x), z)
        want = np.asarray(want)
    if case == "filtfilt":
        got = P.filtfilt(b, a, _t(x), zi)
    else:
        got = P.lfilter(b, a, _t(x), zi if case == "lfilter_zi" else None)
    assert got.dtype == torch.float64
    _close(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("zi_kind", [None, "template", "full"])
@pytest.mark.parametrize("return_zf", [False, True])
def test_sosfilt_matches_jax(sig, alpha, zi_kind, return_zf):
    sos, zi = alpha
    x = sig.reshape(600, 2, 2)          # trailing dims flatten into series
    z = {None: None, "template": zi,
         "full": np.random.default_rng(1).standard_normal(
             (4, 2, 2, 2)).astype(np.float32)}[zi_kind]
    want = J.sosfilt(sos, jnp.asarray(x),
                     None if z is None else jnp.asarray(z), return_zf)
    got = P.sosfilt(sos, _t(x), z, return_zf)
    if return_zf:
        (got, got_zf), (want, want_zf) = got, want
        assert got_zf.shape == want_zf.shape == (4, 2, 2, 2)
        _close_filtered(got_zf, want_zf)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close_filtered(got, want)


def test_sosfilt_chunked_carry_equals_one_shot(sig, alpha):
    """The stream's contract: chunks with the carried state give exactly
    the one-shot output and final state."""
    sos, _ = alpha
    x = _t(sig)
    whole, zf = P.sosfilt(sos, x, np.zeros((4, 2, 4), np.float32), True)
    z, pieces = torch.zeros(4, 2, 4), []
    for k in range(0, 600, 50):
        y, z = P.sosfilt(sos, x[k:k + 50], z, return_zf=True)
        pieces.append(y)
    assert torch.equal(torch.cat(pieces), whole) and torch.equal(z, zf)


def test_grouped_series_equal_separate_cascades(sig):
    """``sosfilt_series`` with G groups filters group g through cascade g:
    the streaming step's one launch for every band."""
    sos = [J.butter_bandpass_sos(lo, hi, FS, 4)[0] for lo, hi in BANDS.values()]
    coeffs = P.sos_coefficients(np.stack(sos))
    x = _t(sig[:200])
    zi = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 4, 2, 4)).astype(np.float32))
    y, zf = P.sosfilt_series(coeffs, x.repeat(1, 3), zi, return_zf=True)
    for g, s in enumerate(sos):
        yg, zg = P.sosfilt(s, x, zi[g], return_zf=True)
        assert torch.equal(y[:, 4 * g:4 * g + 4], yg)
        assert torch.equal(zf[g], zg)


def test_sosfiltfilt_and_bandpass_match_jax(sig, alpha):
    sos, zi = alpha
    _close_filtered(P.sosfiltfilt(sos, _t(sig), zi),
                    J.sosfiltfilt(sos, jnp.asarray(sig), zi))
    batch = np.stack([sig[:300], 2 * sig[300:] + 1])          # (2, T, C)
    _close_filtered(P.bandpass_filtfilt(_t(batch), 13, 30, FS),
                    J.bandpass_filtfilt(jnp.asarray(batch), 13, 30, FS))
    with pytest.raises(ValueError, match="padlen"):
        P.sosfiltfilt(sos, _t(sig[:27]), zi)


@pytest.mark.parametrize("T,L,hop", [(600, 128, 64), (601, 100, 37)])
def test_frames_epochs_and_window_match_jax(sig, T, L, hop):
    x = np.concatenate([sig, sig])[:T]
    want = np.asarray(J.frame_signal(jnp.asarray(x), L, hop))
    got = P.frame_signal(_t(x), L, hop)
    assert got.shape == want.shape == (1 + (T - L) // hop, L, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.epoch_signal(_t(x), 100).numpy(),
                                  np.asarray(J.epoch_signal(jnp.asarray(x),
                                                            100)))
    _close(P.hann_window(L), J.hann_window(L), rtol=0, atol=1e-7)


def test_spectra_match_jax(sig):
    x = sig.T[None]                                       # (1, C, T)
    _close(P.stft(_t(x), 128, 64), J.stft(jnp.asarray(x), 128, 64))
    _close(P.stft(_t(x), 100, 30, scale=False),
           J.stft(jnp.asarray(x), 100, 30, scale=False), atol=1e-5)
    p = P.spectrogram_power(_t(x), 128, 64)
    pj = J.spectrogram_power(jnp.asarray(x), 128, 64)
    assert p.dtype == torch.float32
    _close(p, pj)
    freqs = J.rfft_freqs(128, FS)
    _close(P.band_power(p, freqs, BANDS),
           J.band_power(pj, jnp.asarray(freqs), BANDS))


@pytest.mark.parametrize("num", [256, 300, 1024, 511])
def test_resample_matches_jax(sig, num):
    _close(P.resample(_t(sig), num, axis=0),
           J.resample(jnp.asarray(sig), num, axis=0))


def test_zscore_and_hilbert_match_jax(sig):
    x = sig.reshape(2, 300, 4)
    for axis in (None, 1, (1, 2)):
        _close(P.zscore(_t(x), axis=axis), J.zscore(jnp.asarray(x), axis=axis))
    for T in (300, 299):                                  # even and odd
        h = P.hilbert_analytic(_t(x[:, :T]), axis=1)
        assert h.dtype == torch.complex64
        _close(h, J.hilbert_analytic(jnp.asarray(x[:, :T]), axis=1))


def test_connectivity_matches_jax(sig):
    x = P.bandpass_filtfilt(_t(sig), 8, 13, FS).numpy()
    epochs = x[:500].reshape(2, 5, 50, 4)                 # (N, E, T, C)
    got = P.connectivity_features(_t(epochs))
    want = jax.vmap(J.connectivity_features)(jnp.asarray(epochs))
    assert got.shape == want.shape == (2, 3 * 6)
    _close(got, want)
    _close(P.connectivity_features(_t(epochs[0]), ("wpli", "plv")),
           J.connectivity_features(jnp.asarray(epochs[0]), ("wpli", "plv")))
    mats = P.connectivity_matrices(_t(epochs))
    assert mats.shape == (2, 4, 4, 3)
    _close(mats, J.connectivity_matrices(jnp.asarray(epochs)))


def test_roi_ops_match_jax():
    r = np.random.default_rng(4)
    V, R, T = 60, 5, 12
    labels = r.integers(0, R + 1, V)
    vols = r.standard_normal((2, T, 3, 4, 5)).astype(np.float32)
    _close(P.normalize_volumes(_t(vols)),
           J.normalize_volumes(jnp.asarray(vols)))
    mem = P.roi_onehot(labels, R)
    np.testing.assert_array_equal(mem, J.roi_onehot(labels, R))
    flat = vols.reshape(2, T, V)
    ts = P.roi_timeseries(_t(flat), _t(mem))
    _close(ts, J.roi_timeseries(jnp.asarray(flat), jnp.asarray(mem)))
    for method in ("mean", "std", "both"):
        _close(P.roi_aggregate(ts, method),
               J.roi_aggregate(jnp.asarray(ts.numpy()), method))
    with pytest.raises(ValueError, match="agg method"):
        P.roi_aggregate(ts, "median")


def test_sosfilt_route_on_the_cpu(sig, alpha, monkeypatch):
    """A CPU tensor takes the plain version and counts no launch; the
    kernel's wrapper refuses a CPU tensor; an input that requires a
    gradient is refused, on every device."""
    sos, _ = alpha
    P.reset_kernel_launches()
    monkeypatch.setattr(P, "sosfilt_cuda", None)   # not reached on the CPU
    P.sosfilt(sos, _t(sig))
    monkeypatch.undo()
    assert P.kernel_launches() == {"sosfilt": 0}
    with pytest.raises(ValueError, match="CUDA"):
        P.sosfilt_cuda(P.sos_coefficients(sos)[None], _t(sig))
    with pytest.raises(ValueError, match="not differentiable"):
        P.sosfilt(sos, _t(sig).requires_grad_())
    with pytest.raises(ValueError, match="not differentiable"):
        P.sosfiltfilt(sos, _t(sig).requires_grad_(), alpha[1])

