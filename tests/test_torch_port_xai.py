"""The port's XAI suite against the JAX package's.

The same seeded flax variables go into both packages' models (a narrow
``TriModalFusionNetV4``: hidden 32, one layer, two heads; a narrow
``BridgeFusionNet``), and the same numpy inputs through both packages'
attribution functions, SHAP, weight extraction, ``Explainer`` and exports.
Target classes are explicit where an argmax tie could flip them. At T=32
the attention takes the einsum route; at T=512 the ERP and PW layers take
the flash route, on the JAX side in interpret mode, as the JAX package's own
tests run its kernels. The JAX functions run under ``jax.jit``, each
compiled once per module.

Tolerances: attributions within 1e-4 of the largest JAX value (a forward
and a backward, many f32 sums in another order); outputs, probabilities and
SHAP values within 1e-5 of the largest; ablation's drops, differences of
two probabilities that cancel to ~1e-4, within 1e-5 of the probabilities
(an f32 ulp of 0.5 is 6e-8, 1e-4 of the drops 4e-8); montage tables and
the numpy analysis functions exactly equal; the text report's lines equal. The port's
own rules: ``make_apply_fn`` leaves the module's mode, weights and grads
alone; integrated gradients and ablation make one batched forward (IG one
backward) whatever the number of steps or channels.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import flash_counts  # noqa: F401 (a fixture)

from multimodal_eeg_fmri_tpu.models.bridge import BridgeFusionNet as JBridge
from multimodal_eeg_fmri_tpu.models.eeg import TriModalFusionNetV4 as JTri
from multimodal_eeg_fmri_tpu.report import export as j_export
from multimodal_eeg_fmri_tpu.xai import analysis as j_analysis
from multimodal_eeg_fmri_tpu.xai import attribution as j_attr
from multimodal_eeg_fmri_tpu.xai import explainer as j_explainer
from multimodal_eeg_fmri_tpu.xai import montage as j_montage
from multimodal_eeg_fmri_tpu.xai import shap_kernel as j_shap
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet as TBridge
from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4 as TTri
from multimodal_eeg_fmri_tpu_torch.report import export as t_export
from multimodal_eeg_fmri_tpu_torch.report import plots as t_plots
from multimodal_eeg_fmri_tpu_torch.xai import analysis as t_analysis
from multimodal_eeg_fmri_tpu_torch.xai import attribution as t_attr
from multimodal_eeg_fmri_tpu_torch.xai import explainer as t_explainer
from multimodal_eeg_fmri_tpu_torch.xai import montage as t_montage
from multimodal_eeg_fmri_tpu_torch.xai import shap_kernel as t_shap

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

TRI = dict(hidden_dim=32, num_transformer_layers=1, num_heads=2, dropout=0.0)
EEG_KEYS = ("erp", "pw", "conn")
ATTR_RTOL = 1e-4     # of the largest JAX value
OUT_RTOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def eeg_inputs(n, T, seed=0):
    return dict(erp=_x(n, T, 18, seed=seed), pw=_x(n, T, 75, seed=seed + 1),
                conn=_x(n, 459, seed=seed + 2))


def seeded(fmod, inputs, seed=0):
    """Flax variables of ``fmod`` (structure from ``eval_shape``, no
    compile), filled from a seed: kernels N(0, 1/fan_in), norm scales and
    fusion logits near 1, biases and means near 0, variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: fmod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        **{k: jnp.zeros(v.shape, v.dtype) for k, v in inputs.items()},
        train=False))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (r.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = {"scale": 1.0, "fusion_logits": 1.0, "temperature": 1.0}
        return (base.get(name, 0.0)
                + 0.05 * r.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(fmod, tmod, inputs, seed=0):
    """(flax module, its variables, the port's CPU module with them)."""
    variables = seeded(fmod, inputs, seed)
    port = load_flax_variables(tmod, variables["params"],
                               variables.get("batch_stats"))
    return fmod, variables, port


@pytest.fixture(scope="module")
def tri():
    return pair(JTri(**TRI), TTri(**TRI, device="cpu"), eeg_inputs(2, 32))


def jax_apply_fn(fmod, variables):
    return j_attr.make_apply_fn(fmod, variables["params"],
                                variables.get("batch_stats"))


def assert_rel(port, ref, rtol, what=""):
    """max |port − ref| ≤ rtol · max |ref|, over one array or a dict."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        for k in ref:
            assert_rel(port[k], ref[k], rtol, f"{what} {k}")
        return
    ref = np.asarray(ref)
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= rtol * scale, f"{what}: max|d| {err:.3e} > {rtol:g} × {scale:.3e}"


# --- montage and the numpy analysis functions: exactly equal -------------

def test_montage_tables_equal():
    for name in ("CHANNEL_NAMES_19", "CHANNEL_NAMES_18", "CHANNEL_NAMES_21",
                 "CHANNEL_NAMES_32", "CHANNEL_POSITIONS", "REGION_GROUPS"):
        assert getattr(t_montage, name) == getattr(j_montage, name), name
    for n in (18, 19, 21, 32, 7):
        names = t_montage.default_channel_names(n)
        assert names == j_montage.default_channel_names(n)
        assert t_montage.pair_names(names) == j_montage.pair_names(names)
    for name in [*t_montage.CHANNEL_POSITIONS, "Ch1"]:
        assert t_montage.channel_region(name) == j_montage.channel_region(name)


@pytest.mark.parametrize("shape,axis,normalize,names", [
    ((4, 32, 18), -1, True, None),
    ((4, 18), -1, False, None),
    ((18, 32), 0, True, None),
    ((3, 10, 7), -1, True, [f"E{i}" for i in range(7)]),
])
def test_channel_importance_equal(shape, axis, normalize, names):
    a = _x(*shape, seed=3)
    got = t_analysis.channel_importance_from_attribution(a, names, axis,
                                                          normalize)
    want = j_analysis.channel_importance_from_attribution(a, names, axis,
                                                          normalize)
    assert (got.values, got.region_values, got.channel_names) == (
        want.values, want.region_values, want.channel_names)
    assert got.top_k(4) == want.top_k(4)
    np.testing.assert_array_equal(got.as_array(), want.as_array())


def test_pair_importance_and_classwise_weights_equal():
    a = _x(4, 459, seed=4)
    assert (t_analysis.connectivity_pair_importance(a)
            == j_analysis.connectivity_pair_importance(a))
    assert (t_analysis.connectivity_pair_importance(a[0, :9])
            == j_analysis.connectivity_pair_importance(a[0, :9]))
    r = np.random.default_rng(5)
    records = [{"label": int(i % 3), "fusion_weights":
                None if i == 4 else r.random(3)} for i in range(9)]
    got = t_analysis.classwise_weight_comparison(records)
    want = j_analysis.classwise_weight_comparison(records)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- attributions against JAX's --------------------------------------------

TARGETS = np.array([1, 0, 0, 1], np.int32)


def _jax_attribution(method, apply_fn, inputs, targets, n_steps):
    if method == "saliency":
        return j_attr.gradient_saliency(apply_fn, inputs, targets)
    if method == "grad_x_input":
        return j_attr.gradient_x_input(apply_fn, inputs, targets)
    if method == "ig":
        return j_attr.integrated_gradients(apply_fn, inputs, targets,
                                           n_steps=n_steps)
    if method == "ig_frozen_conn":
        return j_attr.integrated_gradients(apply_fn, inputs, targets,
                                           n_steps=n_steps,
                                           frozen_keys=("conn",))
    return j_attr.ablation_importance(apply_fn, inputs, "erp", -1, targets)


def _port_attribution(method, apply_fn, inputs, targets, n_steps):
    if method == "saliency":
        return t_attr.gradient_saliency(apply_fn, inputs, targets)
    if method == "grad_x_input":
        return t_attr.gradient_x_input(apply_fn, inputs, targets)
    if method == "ig":
        return t_attr.integrated_gradients(apply_fn, inputs, targets,
                                           n_steps=n_steps)
    if method == "ig_frozen_conn":
        return t_attr.integrated_gradients(apply_fn, inputs, targets,
                                           n_steps=n_steps,
                                           frozen_keys=("conn",))
    return t_attr.ablation_importance(apply_fn, inputs, "erp", -1, targets)


METHODS = ["saliency", "grad_x_input", "ig", "ig_frozen_conn", "ablation"]


@pytest.mark.parametrize("method", METHODS)
def test_attribution_matches_jax(tri, method):
    """T=32 (the einsum route), 4 rows, IG over 16 steps; ablation over
    the 18 ERP channels."""
    fmod, variables, port = tri
    inputs = eeg_inputs(4, 32, seed=10)
    apply_j = jax_apply_fn(fmod, variables)
    want = jax.jit(lambda inp, t: _jax_attribution(method, apply_j, inp, t,
                                                   16))(
        {k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(TARGETS))
    got = _port_attribution(method, t_attr.make_apply_fn(port), inputs,
                            torch.as_tensor(TARGETS), 16)
    if method == "ablation":
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        assert err <= OUT_RTOL, f"ablation: max|d| {err:.3e} (probabilities)"
    else:
        assert_rel(got, jax.device_get(want), ATTR_RTOL, method)


def test_attribution_flash_route_matches_jax(tri, flash_counts):
    """T=512: the ERP and PW layers take the flash route in the forward and
    the backward of saliency and of IG (2 rows × 4 steps folded into one
    batch of 8), the JAX kernels in interpret mode."""
    fmod, variables, port = tri
    inputs = eeg_inputs(2, 512, seed=11)
    targets = TARGETS[:2]
    apply_j = jax_apply_fn(fmod, variables)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = jax.device_get(jax.jit(lambda inp, t: (
        j_attr.gradient_saliency(apply_j, inp, t),
        j_attr.integrated_gradients(apply_j, inp, t, n_steps=4)))(
            jin, jnp.asarray(targets)))
    apply_t = t_attr.make_apply_fn(port)
    t_targets = torch.as_tensor(targets)
    got = (t_attr.gradient_saliency(apply_t, inputs, t_targets),
           t_attr.integrated_gradients(apply_t, inputs, t_targets, n_steps=4))
    # two flash layers, each once forward and once backward per attribution
    # (JAX counts while tracing; the target-class forwards are skipped)
    assert flash_counts["port_fwd"] == flash_counts["port_bwd"] == 4
    assert flash_counts["jax_fwd"] >= 2 and flash_counts["jax_bwd"] >= 2
    for name, g, w in zip(("saliency", "ig"), got, want):
        assert_rel(g, w, ATTR_RTOL, name)


def test_make_apply_fn_leaves_the_module_alone(tri):
    _, _, port = tri
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    apply_fn = t_attr.make_apply_fn(port)
    inputs = eeg_inputs(4, 32, seed=12)
    t_attr.gradient_saliency(apply_fn, inputs)
    t_attr.integrated_gradients(apply_fn, inputs, n_steps=3)
    assert port.training
    assert all(p.grad is None for p in port.parameters())
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    # eval mode inside: the logits equal an eval-mode forward
    port.eval()
    with torch.no_grad():
        ref = port(**{k: torch.as_tensor(v) for k, v in inputs.items()})
    torch.testing.assert_close(apply_fn(inputs), ref.logits, rtol=0, atol=0)


def _counting(apply_fn, rows):
    def wrapper(inputs):
        rows.append(next(iter(inputs.values())).shape[0])
        return apply_fn(inputs)

    wrapper.device = apply_fn.device
    return wrapper


@pytest.mark.parametrize("n_steps", [3, 7])
def test_ig_and_ablation_fold_into_one_batch(tri, n_steps):
    """IG makes one forward over n_steps × B rows (and one backward), after
    the target-class forward; ablation one over n_ch × B rows after the
    base forward; an explicit target makes no extra forward."""
    _, _, port = tri
    inputs = eeg_inputs(4, 32, seed=13)
    rows = []
    apply_fn = _counting(t_attr.make_apply_fn(port), rows)
    t_attr.integrated_gradients(apply_fn, inputs, n_steps=n_steps)
    assert rows == [4, 4 * n_steps]
    rows.clear()
    t_attr.integrated_gradients(apply_fn, inputs, TARGETS, n_steps=n_steps)
    assert rows == [4 * n_steps]
    rows.clear()
    t_attr.ablation_importance(apply_fn, inputs, "pw", axis=-1, target_class=1)
    assert rows == [4, 4 * 75]


def test_ablation_along_time_axis_matches_a_loop(tri):
    """Masks along a middle axis: the folded batch equals zeroing one time
    step at a time."""
    _, _, port = tri
    inputs = eeg_inputs(2, 8, seed=14)
    apply_fn = t_attr.make_apply_fn(port)
    got = t_attr.ablation_importance(apply_fn, inputs, "erp", axis=1,
                                     target_class=0)
    with torch.no_grad():
        x = {k: torch.as_tensor(v) for k, v in inputs.items()}
        base = torch.softmax(apply_fn(x), -1)[:, 0]
        want = []
        for t in range(8):
            erp = x["erp"].clone()
            erp[:, t] = 0.0
            want.append(base - torch.softmax(apply_fn({**x, "erp": erp}),
                                             -1)[:, 0])
    torch.testing.assert_close(got, torch.stack(want, 1), atol=1e-6, rtol=0)


# --- Kernel SHAP --------------------------------------------------------

@pytest.fixture(scope="module")
def bridge():
    inputs = dict(eeg=_x(2, 4, seed=20), fmri=_x(2, 4, seed=21))
    return pair(JBridge(eeg_dim=4, fmri_dim=4, bridge_dim=16, num_heads=2),
                TBridge(eeg_dim=4, fmri_dim=4, bridge_dim=16, num_heads=2,
                        device="cpu"), inputs, seed=2)


@pytest.mark.parametrize("exact,n_samples", [(True, 0), (False, 40)])
def test_kernel_shap_on_the_bridge_matches_jax(bridge, exact, n_samples):
    """M = 8 (4 + 4 features): exact enumeration of all 254 coalitions, and
    sampled mode with the same seed (the same coalitions on both sides);
    the class-1 probabilities of every coalition row first."""
    fmod, variables, port = bridge
    template = {"eeg": (4,), "fmri": (4,)}
    X = _x(5, 8, seed=22)
    bg = _x(10, 8, seed=23)
    f_j = j_shap.make_class_prob_fn(fmod, variables["params"], None, template)
    f_t = t_shap.make_class_prob_fn(port, None, None, template)
    rows = _x(64, 8, seed=24)
    assert_rel(f_t(rows), np.asarray(f_j(rows)), OUT_RTOL, "probs")
    kw = dict(n_samples=n_samples, exact=exact)
    got = t_shap.kernel_shap(f_t, X, bg, rng=np.random.default_rng(3), **kw)
    want = j_shap.kernel_shap(f_j, X, bg, rng=np.random.default_rng(3), **kw)
    assert got.shape == want.shape == (5, 8)
    assert_rel(got, want, OUT_RTOL, "shap")


def test_kernel_shap_linear_oracle_and_one_batch():
    """A linear model's Shapley values are w_i (x_i − bg_i): exactly with
    enumeration, within 1e-3 sampled (the JAX package's oracle); every
    coalition row of every sample goes to ``f`` in one call."""
    r = np.random.default_rng(1)
    w, bg, X = r.standard_normal(8), r.standard_normal(8), r.standard_normal(
        (3, 8))
    calls = []

    def f(x):
        calls.append(len(x))
        return x @ w + 1.7

    expected = w[None, :] * (X - bg[None, :])
    np.testing.assert_allclose(t_shap.kernel_shap(f, X, bg, exact=True),
                               expected, rtol=1e-5, atol=1e-5)
    assert calls == [3, 1, 3 * 254]
    phi = t_shap.kernel_shap(f, X, bg, n_samples=400,
                             rng=np.random.default_rng(2))
    np.testing.assert_allclose(phi, expected, rtol=1e-3, atol=1e-3)
    Z = t_shap._coalition_sample(8, 9, np.random.default_rng(4))
    np.testing.assert_array_equal(
        Z, j_shap._coalition_sample(8, 9, np.random.default_rng(4)))


def test_class_prob_fn_on_eeg_matches_jax(tri):
    """The flattened-concat convention on the tri-modal net (T=16: M =
    16·18 + 16·75 + 459), all rows in one call."""
    fmod, variables, port = tri
    template = {"erp": (16, 18), "pw": (16, 75), "conn": (459,)}
    rows = _x(6, 16 * 18 + 16 * 75 + 459, seed=25)
    f_j = j_shap.make_class_prob_fn(fmod, variables["params"],
                                    variables["batch_stats"], template,
                                    class_idx=0)
    f_t = t_shap.make_class_prob_fn(port, None, None, template, class_idx=0)
    assert_rel(f_t(rows), np.asarray(f_j(rows)), OUT_RTOL, "probs")


# --- weight extraction, Explainer, exports ------------------------------

def test_extract_attention_and_fusion_weights_matches_jax(tri):
    fmod, variables, port = tri
    data = {**eeg_inputs(5, 32, seed=30),
            "label": np.array([0, 1, 1, 0, 1], np.int32),
            "subject": np.array([3, 5, 8, 9, 12], np.int32)}
    got = t_analysis.extract_attention_and_fusion_weights(port, None, None,
                                                          data)
    want = j_analysis.extract_attention_and_fusion_weights(
        fmod, variables["params"], variables["batch_stats"], data)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("subject", "label")} == {
            k: w[k] for k in ("subject", "label")}
        for k in ("fusion_weights", "attn_weights"):
            assert g[k].shape == w[k].shape
            assert_rel(g[k], w[k], OUT_RTOL, k)
    # the prediction is the argmax of logits within 1e-5 of JAX's
    logits = jax.device_get(jax.jit(jax_apply_fn(fmod, variables))(
        {k: jnp.asarray(data[k]) for k in EEG_KEYS}))
    clear = np.abs(logits[:, 0] - logits[:, 1]) > 1e-4
    assert [g["prediction"] for g, c in zip(got, clear) if c] == [
        w["prediction"] for w, c in zip(want, clear) if c]


@pytest.fixture(scope="module")
def explained(tri, tmp_path_factory):
    """Both packages' ``analyze_dataset`` (which runs ``explain``) on 4 rows
    at T=32, IG over 8 steps."""
    fmod, variables, port = tri
    inputs = eeg_inputs(4, 32, seed=40)
    metrics = {"f1": 0.75, "auc": 0.8125}
    out_j = tmp_path_factory.mktemp("jax")
    out_t = tmp_path_factory.mktemp("port")
    explainer = j_explainer.Explainer(
        fmod, variables["params"], variables["batch_stats"], ig_steps=8)
    # each forward compiled once, inside the attributions' grad and vmap
    explainer.apply_fn = jax.jit(explainer.apply_fn)
    want = explainer.analyze_dataset(inputs, out_j, metrics, TARGETS)
    got = t_explainer.Explainer(port, ig_steps=8).analyze_dataset(
        inputs, out_t, metrics, torch.as_tensor(TARGETS))
    return got, want, out_t, out_j


def test_explainer_explain_matches_jax(explained):
    got, want = explained[:2]
    assert_rel(got.probs, want.probs, OUT_RTOL, "probs")
    for name in ("saliency", "grad_x_input", "integrated_gradients"):
        assert_rel(getattr(got, name), getattr(want, name), ATTR_RTOL, name)
    assert sorted(got.channel_importance) == ["erp", "pw"]
    for k, ci in want.channel_importance.items():
        assert got.channel_importance[k].channel_names == ci.channel_names
        assert_rel(got.channel_importance[k].as_array(), ci.as_array(),
                   ATTR_RTOL, f"channel importance {k}")
        assert_rel(np.array(list(got.region_importance[k].values())),
                   np.array(list(want.region_importance[k].values())),
                   ATTR_RTOL, f"regions {k}")
    assert list(got.pair_importance) == list(want.pair_importance)
    assert_rel(np.array(list(got.pair_importance.values())),
               np.array(list(want.pair_importance.values())), ATTR_RTOL,
               "pairs")


def test_analyze_dataset_writes_the_same_artifacts(explained):
    _, _, out_t, out_j = explained
    names = sorted(p.name for p in out_t.iterdir())
    assert names == sorted(p.name for p in out_j.iterdir())
    assert names == ["channel_importance.png", "region_radar.png",
                     "topomap.png", "xai_arrays.npz", "xai_report.txt"]
    got, want = np.load(out_t / "xai_arrays.npz"), np.load(
        out_j / "xai_arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert_rel(got[k], want[k], ATTR_RTOL, k)
    assert ((out_t / "xai_report.txt").read_text().splitlines()
            == (out_j / "xai_report.txt").read_text().splitlines())


def test_exports_match_jax(tmp_path):
    """The CSV and NPZ writers on the same inputs (pandas on this host)."""

    class FakeCV:
        fold_metrics = {"f1": np.asarray([0.6, 0.7]),
                        "auc": np.asarray([0.5, 0.9])}
        summary = {"f1": (0.65, 0.05), "auc": (0.7, 0.2)}

    records = [{"subject": 3, "label": 1, "prediction": 0,
                "fusion_weights": np.array([0.4, 0.6], np.float32)}]
    for mod, d in ((t_export, tmp_path / "port"), (j_export, tmp_path / "jax")):
        mod.export_cv_results({"m": FakeCV()}, d, timestamp=False)
        mod.export_xai_arrays({"ig": np.eye(3)}, d, timestamp=False)
        mod.export_per_subject_records(records, d, timestamp=False)
    for name in ("results_detailed.csv", "results_summary.csv",
                 "per_subject.csv"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "xai_arrays.npz")["ig"], np.eye(3))


def test_plots_smoke(tmp_path):
    """Every figure of the port's ``report/plots.py`` is written (the JAX
    package's plots smoke test, on the port)."""
    r = np.random.default_rng(0)

    class FakeCV:
        fold_metrics = {"f1": np.asarray([0.6, 0.7, 0.65]),
                        "accuracy": np.asarray([0.6, 0.72, 0.66])}
        summary = {"f1": (0.65, 0.04), "accuracy": (0.66, 0.05)}
        history = {"train_loss": r.random((3, 10))}

    res = FakeCV()
    probs1 = r.random(30)
    labels = r.integers(0, 2, 30)
    ci = t_analysis.channel_importance_from_attribution(r.random((4, 16, 18)))
    paths = [
        t_plots.plot_model_comparison({"a": res, "b": res},
                                      path=tmp_path / "cmp.png"),
        t_plots.plot_fold_metrics(res, path=tmp_path / "folds.png"),
        t_plots.plot_training_history(res, path=tmp_path / "h.png"),
        t_plots.plot_fusion_weights(r.random((5, 3)), ["erp", "pw", "conn"],
                                    tmp_path / "fw.png"),
        t_plots.plot_roc(probs1, labels, tmp_path / "roc.png"),
        t_plots.plot_confusion((probs1 > 0.5).astype(int), labels,
                               tmp_path / "cm.png"),
        t_plots.plot_tsne_embeddings(r.random((30, 8)), labels,
                                     tmp_path / "tsne.png"),
        t_plots.plot_reliability(probs1.astype(np.float32), labels,
                                 path=tmp_path / "rel.png"),
        t_plots.plot_threshold_sweep(probs1.astype(np.float32), labels,
                                     path=tmp_path / "sweep.png"),
        t_plots.plot_channel_importance(ci, tmp_path / "ch.png"),
        t_plots.plot_topomap(ci, tmp_path / "topo.png"),
        t_plots.plot_region_radar(ci, tmp_path / "radar.png"),
        t_plots.plot_connectivity_matrix(r.random((18, 18)), ci.channel_names,
                                         tmp_path / "conn.png"),
    ]
    assert all(p.exists() and p.stat().st_size > 0 for p in paths)
