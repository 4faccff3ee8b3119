"""S1's chunked time-parallel scan in plain PyTorch (``ops/signal.py``:
``sosfilt_carry_matrix``, ``sosfilt_chunked_plain``, ``sosfilt_schedule``)
against the sequential recurrence, its float64 counterpart and the JAX
package's ``sosfilt``, on the same numpy inputs from a seed. The card test
of the kernel itself, bit for bit against ``sosfilt_chunked_plain``, is in
``test_torch_port_kernel.py``.

Tolerances, each with its reason:

- A^L against L zero-input float64 steps: 1e-11 of its largest entry (the
  squarings round in another order, and the delta band's transient, |A^k|
  up to ~3e3, carries each rounding: measured up to 1.7e-12 at L = 200);
  its blocks above the diagonal are zero exactly (a section's state never
  reaches an earlier section);
- with chunk >= T the chunked schedule is the sequential one: equal;
- the chunked result's error against the float64 recurrence (the plain
  recurrence on float64 tensors, the float32 coefficients taken exactly) is
  at most 1.5× the sequential float32 result's, band by band: the chunks
  carry their start states in float64 and round them once, so they add no
  error of their own beyond that margin; for the alpha band it is also
  within 2e-5 of the largest |y|, the kernel's gate in ``chip_smoke.py``;
- the chunked alpha band against JAX's ``sosfilt``: 1e-5 of the largest
  |y|, the port's tolerance for the float32 cascade
  (``test_torch_port_signal.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.ops import signal as J
from multimodal_eeg_fmri_tpu_torch.data.raw import DEFAULT_BANDS
from multimodal_eeg_fmri_tpu_torch.ops import signal as P

FS = 250.0
T_LONG, SERIES = 2554, 6        # the featurizer's T, a few series per band
BANDS = list(DEFAULT_BANDS)
ERROR_RATIO = 1.5               # chunked vs sequential, against float64
ALPHA_RTOL = 2e-5               # of the largest |y|, against float64
F32_FILTER_RTOL = 1e-5          # of the largest |y|, against JAX


def _coeffs(bands=BANDS):
    return P.sos_coefficients(np.stack(
        [P.butter_bandpass_sos(*DEFAULT_BANDS[b], FS, 4)[0] for b in bands]))


def _inputs(T, G, with_zi, seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((T, G * SERIES), dtype=np.float32))
    zi = (torch.from_numpy(r.standard_normal((G, 4, 2, SERIES),
                                             dtype=np.float32))
          if with_zi else None)
    return x, zi


@pytest.fixture(scope="module")
def five_bands():
    """The five bands as groups of one launch at T=2554, with and without
    a start state: inputs, the sequential float32 result and the float64
    recurrence, each run once."""
    coeffs, runs = _coeffs(), {}
    for with_zi in (True, False):
        x, zi = _inputs(T_LONG, len(BANDS), with_zi)
        seq = P.sosfilt_plain(coeffs, x, zi)
        f64 = P.sosfilt_plain(coeffs, x.double(),
                              None if zi is None else zi.double())
        runs[with_zi] = (x, zi, seq, f64)
    return coeffs, runs


def _band_errors(got, seq, f64, g):
    """max |Δy| of the chunked and the sequential results against float64
    in group g, and the group's largest |y|."""
    cols = slice(g * SERIES, (g + 1) * SERIES)
    want = f64[0][:, cols]
    return ((got[0][:, cols] - want).abs().max().item(),
            (seq[0][:, cols] - want).abs().max().item(),
            want.abs().max().item())


@pytest.mark.parametrize("L", [1, 16, 48, 64, 200])
def test_carry_matrix_is_L_zero_input_steps(L):
    coeffs = _coeffs()
    got = P.sosfilt_carry_matrix(coeffs, L)
    eye = np.broadcast_to(np.eye(8), (5, 8, 8))
    want = P._zero_input_steps(coeffs, eye, L)
    assert got.shape == (5, 8, 8) and got.dtype == np.float64
    for g in range(5):
        np.testing.assert_allclose(got[g], want[g], rtol=0,
                                   atol=1e-11 * np.abs(want[g]).max())
    upper = np.kron(np.triu(np.ones((4, 4)), 1), np.ones((2, 2))) > 0
    assert not got[:, upper].any()


@pytest.mark.parametrize("chunk", [T_LONG, T_LONG + 5, 10**9])
def test_chunk_at_least_T_is_the_sequential_recurrence(five_bands, chunk):
    coeffs, runs = five_bands
    x, zi, seq, _ = runs[True]
    y, zf = P.sosfilt_chunked_plain(coeffs, x, zi, chunk)
    assert torch.equal(y, seq[0]) and torch.equal(zf, seq[1])


@pytest.mark.parametrize("with_zi", [True, False])
@pytest.mark.parametrize("chunk", [16, 48, 80])
def test_five_bands_in_one_launch_against_float64(five_bands, chunk,
                                                   with_zi):
    """G = 5; T = 2554 leaves a partial last chunk at each length."""
    coeffs, runs = five_bands
    x, zi, seq, f64 = runs[with_zi]
    assert T_LONG % chunk
    got = P.sosfilt_chunked_plain(coeffs, x, zi, chunk)
    assert got[0].shape == x.shape and got[1].shape == (5, 4, 2, SERIES)
    for g, band in enumerate(BANDS):
        err, err_seq, peak = _band_errors(got, seq, f64, g)
        assert err <= ERROR_RATIO * err_seq, (band, err, err_seq)
        if band == "alpha":
            assert err <= ALPHA_RTOL * peak
    zf_err = (got[1] - f64[1]).abs().max().item()
    assert zf_err <= ALPHA_RTOL * f64[0].abs().max().item()


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("with_zi", [True, False])
def test_each_band_alone_on_the_rules_schedule(five_bands, band, with_zi):
    """G = 1 at the featurizer's T, on the rule's chunk length; the same
    series as group g of the five-band launch."""
    _, runs = five_bands
    x, zi, seq, f64 = runs[with_zi]
    g = BANDS.index(band)
    cols = slice(g * SERIES, (g + 1) * SERIES)
    chunk = P.sosfilt_schedule(T_LONG, SERIES, 1, 4)
    assert chunk < T_LONG
    y, zf = P.sosfilt_chunked_plain(
        _coeffs([band]), x[:, cols].contiguous(),
        None if zi is None else zi[g:g + 1].contiguous())
    y_all = torch.zeros_like(x)
    y_all[:, cols] = y
    err, err_seq, peak = _band_errors((y_all,), seq, f64, g)
    assert err <= ERROR_RATIO * err_seq, (err, err_seq)
    if band == "alpha":
        assert err <= ALPHA_RTOL * peak
    assert (zf[0] - f64[1][g]).abs().max().item() <= ALPHA_RTOL * peak


@pytest.mark.parametrize("T,chunk", [
    (40, 64),      # T < L: one chunk
    (480, 48),     # a whole last chunk
    (481, 48),     # a last chunk of one sample
    (17, 16),
])
def test_chunk_edges_against_float64(T, chunk):
    coeffs = _coeffs()
    x, zi = _inputs(T, len(BANDS), True, seed=3)
    y, zf = P.sosfilt_chunked_plain(coeffs, x, zi, chunk)
    seq = P.sosfilt_plain(coeffs, x, zi)
    if chunk >= T:
        assert torch.equal(y, seq[0]) and torch.equal(zf, seq[1])
    f64 = P.sosfilt_plain(coeffs, x.double(), zi.double())
    for g in range(len(BANDS)):
        err, err_seq, peak = _band_errors((y, zf), seq, f64, g)
        assert err <= ERROR_RATIO * err_seq, (g, err, err_seq)
    assert (zf - f64[1]).abs().max().item() <= ALPHA_RTOL * f64[0].abs().max()


@pytest.fixture(scope="module")
def alpha_jax():
    """The alpha band at T=2554 over (S, 2, series) state, through JAX's
    ``sosfilt``: (x, zi, y, zf)."""
    sos = J.butter_bandpass_sos(*DEFAULT_BANDS["alpha"], FS, 4)[0]
    x, zi = _inputs(T_LONG, 1, True, seed=4)
    y, zf = J.sosfilt(sos, jnp.asarray(x.numpy()), jnp.asarray(zi[0].numpy()),
                      True)
    return x, zi, np.asarray(y), np.asarray(zf)


@pytest.mark.parametrize("chunk", [None, 16, 64])
def test_chunked_alpha_matches_jax(alpha_jax, chunk):
    x, zi, want_y, want_zf = alpha_jax
    y, zf = P.sosfilt_chunked_plain(_coeffs(["alpha"]), x, zi, chunk)
    atol = F32_FILTER_RTOL * np.abs(want_y).max()
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=atol)
    np.testing.assert_allclose(zf[0].numpy(), want_zf, rtol=0, atol=atol)


@pytest.mark.parametrize("T,M,G,S,sequential", [
    (50, 90, 5, 4, True),          # one stream chunk, five bands
    (1, 1, 1, 4, True),
    (2554, 288, 1, 4, False),      # the featurizer's pass
    (2554, 720, 1, 4, False),      # raw-e2e's
    (304, 144, 1, 4, True),        # raw-in-step's: its chain < the host cost
    (1054, 12, 1, 4, False),
    (2554, 10**6, 1, 4, True),     # series that fill the card alone
])
def test_schedule(T, M, G, S, sequential):
    L = P.sosfilt_schedule(T, M, G, S)
    if sequential:
        assert L >= T
    else:
        assert L < T and L % P.SOS_TILE == 0


@pytest.mark.parametrize("chunk", [0, -16, 24, 16.0, True, "16"])
def test_bad_chunk_is_refused(chunk):
    x, zi = _inputs(40, 1, True)
    with pytest.raises(ValueError, match="chunk"):
        P.sosfilt_chunked_plain(_coeffs(["alpha"]), x, zi, chunk)
