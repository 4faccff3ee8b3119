"""The port's raw-signal modules against the JAX package's, on the same
numpy inputs from a seed: the raw EEG featurizer (``data/raw.py``), NIfTI I/O
and the fMRI ROI pipeline (``data/nifti.py``), the streaming featurizer
(``data/streaming.py``), and the slice as a whole, raw recordings → dataset →
one train step of a narrow ``MultimodalEndToEnd`` with the weights carried
from flax. The port runs on the CPU, where ``sosfilt`` takes S1's plain
version. Each JAX run is shared through a module fixture.

Tolerances: ERP 1e-6 (a mean of the same samples); PW 1e-5 relative (f32
FFTs); CONN 1e-4 absolute, since the band-passed signal differs by up to
~4e-6 of its peak between two f32 cascades and the PLV/COH/WPLI ratios carry
that into the features; ROI features 1e-5 (an f32 matmul and moments summed
in another order); the stream's entries as the featurizer's; the train
step's loss 1e-5 and gradients 1e-4, as the train-step tests in
``test_torch_port_train.py`` hold them, here with the feature differences
above flowing through.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.data import nifti as j_nifti
from multimodal_eeg_fmri_tpu.data import raw as j_raw
from multimodal_eeg_fmri_tpu.data import streaming as j_stream
from multimodal_eeg_fmri_tpu.models.multimodal import MultimodalEndToEnd as JE2E
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.data import nifti as t_nifti
from multimodal_eeg_fmri_tpu_torch.data import raw as t_raw
from multimodal_eeg_fmri_tpu_torch.data import streaming as t_stream
from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
from multimodal_eeg_fmri_tpu_torch.models.multimodal import (
    MultimodalEndToEnd as TE2E,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

N, T, C, EPOCH, FS = 4, 1000, 6, 250, 250.0
CHUNK = 50
PAIRS = C * (C - 1) // 2
TOL = {"erp": dict(rtol=0, atol=1e-6), "pw": dict(rtol=1e-5, atol=1e-7),
       "conn": dict(rtol=0, atol=1e-4)}


def _close(got, want, **tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.fixture(scope="module")
def raw():
    """(N, T, C) recordings; odd rows carry a strong 10 Hz rhythm."""
    r = np.random.default_rng(0)
    alpha = np.sin(2 * np.pi * 10 * np.arange(T) / FS)[None, :, None]
    x = r.standard_normal((N, T, C)) + 2.0 * (np.arange(N) % 2)[:, None,
                                                                 None] * alpha
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def datasets(raw):
    """(JAX dataset, port dataset) of ``raw_recordings_to_dataset``."""
    labels = np.arange(N) % 2
    return (j_raw.raw_recordings_to_dataset(raw, labels, epoch_len=EPOCH),
            t_raw.raw_recordings_to_dataset(raw, labels, epoch_len=EPOCH,
                                            device="cpu"))


@pytest.mark.parametrize("key", ["erp", "pw", "conn"])
def test_featurizer_matches_jax(raw, datasets, key):
    want, got = datasets
    assert got[key].dtype == np.float32
    _close(got[key], want[key], **TOL[key])
    assert got["erp"].shape == (N, EPOCH, C)
    assert got["conn"].shape == (N, 3 * PAIRS)
    assert got["pw"].shape == (N, 1 + (T - 128) // 64, C * 5)


def test_dataset_keys_and_featurizer_options(raw, datasets):
    want, got = datasets
    assert got.keys() == want.keys()
    for k in ("label", "subject"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32
    subjects = np.array([7, 3, 9, 1])
    ds = t_raw.raw_recordings_to_dataset(raw[:2, :600].astype(np.float64),
                                         [1, 0], subjects[:2], device="cpu",
                                         epoch_len=200, conn_band="beta",
                                         nperseg=64)
    ref = j_raw.raw_recordings_to_dataset(raw[:2, :600], [1, 0], subjects[:2],
                                          epoch_len=200, conn_band="beta",
                                          nperseg=64)
    np.testing.assert_array_equal(ds["subject"], [7, 3])
    for key in ("erp", "pw", "conn"):
        _close(ds[key], ref[key], **TOL[key])


@pytest.fixture(scope="module")
def bold():
    r = np.random.default_rng(3)
    vols = r.standard_normal((6, 5, 4, 20)).astype(np.float32) + 3.0
    atlas = r.integers(0, 6, (6, 5, 4)).astype(np.int32)
    return vols, atlas


@pytest.mark.parametrize("time_last,agg", [(True, "both"), (False, "mean"),
                                           (True, "std")])
def test_roi_features_match_jax(bold, time_last, agg):
    vols, atlas = bold
    if not time_last:
        vols = np.moveaxis(vols, -1, 0)
    want = j_nifti.volumes_to_roi_features(vols, atlas, agg_method=agg,
                                           time_last=time_last)
    got = t_nifti.volumes_to_roi_features(vols, atlas, agg_method=agg,
                                          time_last=time_last, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_nifti_round_trip_and_subject_features(bold, tmp_path):
    vols, atlas = bold
    p = t_nifti.write_nifti(tmp_path / "bold.nii.gz", vols)
    a = t_nifti.write_nifti(tmp_path / "atlas.nii", atlas.astype(np.int16))
    data, hdr = t_nifti.read_nifti(p)
    assert hdr["shape"] == vols.shape and hdr["datatype"] == 16
    np.testing.assert_array_equal(data, vols)
    np.testing.assert_array_equal(j_nifti.read_nifti(a)[0], atlas)
    _close(t_nifti.load_subject_volume_features(p, a, device="cpu"),
           j_nifti.load_subject_volume_features(p, a), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def sessions(raw):
    """(JAX stream_session outputs, the port's) over one recording."""
    session = raw[1]                                      # (T, C), alpha-laden
    init, step = j_stream.make_streaming_featurizer(
        fs=FS, epoch_len=EPOCH, chunk_len=CHUNK)
    want = j_stream.stream_session(jnp.asarray(session), CHUNK, init, step)
    init, step = t_stream.make_streaming_featurizer(
        fs=FS, epoch_len=EPOCH, chunk_len=CHUNK, device="cpu")
    got = t_stream.stream_session(torch.from_numpy(session), CHUNK, init, step)
    return jax.tree.map(np.asarray, want), got


@pytest.mark.parametrize("key", ["ready", "erp", "pw", "conn"])
def test_stream_session_matches_jax(sessions, key):
    want, got = sessions
    assert got[key].shape == want[key].shape
    assert got[key].shape[0] == T // CHUNK
    if key == "ready":
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    else:
        _close(got[key], want[key], **TOL[key])


def test_stream_state_and_schedule():
    with pytest.raises(ValueError, match="divide"):
        t_stream.make_streaming_featurizer(epoch_len=250, chunk_len=60,
                                           device="cpu")
    with pytest.raises(ValueError, match="conn_band"):
        t_stream.make_streaming_featurizer(conn_band="mu", device="cpu")
    init, step = t_stream.make_streaming_featurizer(device="cpu")
    state = init(3)
    assert state.zi.shape == (5, 4, 2, 3)
    for i in range(5):
        state, out = step(state, np.ones((50, 3)))
    assert out["ready"] and state.fill == 0 and state.epoch_idx == 1
    assert out["erp"].dtype == torch.float32


def test_entry_points_build_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for make in (t_raw.make_raw_eeg_featurizer,
                 t_stream.make_streaming_featurizer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nifti.volumes_to_roi_features(np.zeros((2, 2, 2, 3)),
                                        np.ones((2, 2, 2), np.int32))


NARROW = dict(eeg_hidden_dim=32, fmri_hidden_dim=16, bridge_dim=32,
              num_transformer_layers=1, num_heads=2, dropout=0.0)
CLASS_WEIGHTS = np.array([0.8, 1.3], np.float32)


def test_raw_slice_train_step_matches_jax(datasets, monkeypatch):
    """Raw recordings → ``raw_recordings_to_dataset`` → one train-mode step
    (weighted CE, backward) of a narrow ``MultimodalEndToEnd`` with the same
    weights: loss and every gradient as JAX's. Dropout and the fusion gate's
    fixed dropout are off on both sides, augmentation is not used."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    j_data, t_data = datasets
    r = np.random.default_rng(5)
    fmri = {"activation": r.standard_normal((N, 90)).astype(np.float32),
            "connectivity": r.standard_normal((N, 64)).astype(np.float32)}
    weight = r.uniform(0.5, 1.5, N).astype(np.float32)
    keys = ("erp", "pw", "conn")
    j_in = {**{k: jnp.asarray(j_data[k]) for k in keys},
            **{k: jnp.asarray(v) for k, v in fmri.items()}}

    fmod = JE2E(**NARROW)
    variables = jax.jit(fmod.init)(jax.random.key(0), **j_in)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (r.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                         if path[-1].key == "var" else
                         np.asarray(v) + 0.05 * r.standard_normal(
                             np.shape(v)).astype(np.float32)), variables)

    def loss_fn(params):
        out, _ = fmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            **j_in, train=True, mutable=["batch_stats"])
        return j_losses.weighted_cross_entropy(
            out.logits, jnp.asarray(j_data["label"]),
            jnp.asarray(CLASS_WEIGHTS), jnp.asarray(weight))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])

    widths = dict(erp_channels=C, pw_channels=5 * C, conn_features=3 * PAIRS)

    def port_model(params, stats):
        return load_flax_variables(TE2E(**NARROW, **widths, device="cpu"),
                                   params, stats)

    model = port_model(variables["params"], variables["batch_stats"])
    for m in model.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    batch = {**{k: torch.from_numpy(t_data[k]) for k in keys},
             **{k: torch.from_numpy(v) for k, v in fmri.items()},
             "label": torch.from_numpy(t_data["label"]),
             "weight": torch.from_numpy(weight)}
    loss_t = TrainStep(model, TrainConfig()).loss(
        batch, torch.from_numpy(CLASS_WEIGHTS))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)

    want = port_model(jax.tree.map(np.asarray, grads_j),
                      variables["batch_stats"]).state_dict()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
