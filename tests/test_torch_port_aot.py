"""The port's program bundles, kernel cache and ``run_cv(aot_dir=...)``
against the JAX package's ``core/aot.py``, ``core/cache.py`` and
``run_cv(aot_dir=...)``, on the CPU.

- A train-mode loss of a ``TriModalFusionNetV4Lite`` (hidden 16, dropout
  0, T = 32) with flax variables carried across (``load_flax_variables``)
  and weights as inputs: ``export_jitted`` and ``load_bundle`` in this
  process and in a fresh one give the live function's loss, outputs
  (a ``ModelOutput``), updated BatchNorm statistics and gradients bit for
  bit, and the JAX package's loss within 1e-5 and gradients within 1e-4
  (as ``test_torch_port_train.py`` holds a train step).
- A flash-routed narrow V4's loss: the graph holds ``mmef::flash_fwd``
  nodes, and the loaded program's backward runs the operator's registered
  gradient (``mmef::flash_bwd``), one call a layer, bit for bit the live
  module's (``_FlashAttention``).
- The operator's own gradient bit for bit ``_FlashAttention``'s (output
  only, with an lse cotangent, an expanded cotangent) and within 2e-5 of
  the JAX package's ``flash_attention_lse`` gradient (interpret mode).
- ``bundle_or_jit``: a miss writes one bundle and its manifest and returns
  the live function, a hit writes none and returns the loaded one; the key
  follows the tag (addresses stripped), the shapes and the row count only
  outside ``ROWS``; a manifest naming a type not registered raises.
- ``run_cv(aot_dir=...)`` of ``test_torch_port_cv.py``'s cohort (a narrow
  V4 on the flash route, folds started from JAX's initial variables): a
  miss (one bundle) and a hit (none new, the loaded program run) each
  equal the run without it bit for bit, and JAX's ``run_cv(aot_dir=...)``
  within that file's 1e-4.
- ``enable_compilation_cache``: the directory it fixes, its idempotence,
  its environment variable, and a second process that loads the library a
  first one built into the same directory without compiling (a stand-in
  toolkit's nvcc records every call: the second asks only its version);
  with no nvcc at all, a process loads the one library there built from
  these sources, and refuses where two toolkits built one each.
- ``training_key``: deterministic per seed, apart from other seeds' and
  from ``generator(seed)``'s streams, on the card by default.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from multimodal_eeg_fmri_tpu.models.eeg import (
    TriModalFusionNetV4Lite as JLite,
)
from multimodal_eeg_fmri_tpu.ops import losses as j_losses
from multimodal_eeg_fmri_tpu_torch import load_flax_variables
from multimodal_eeg_fmri_tpu_torch.core import aot
from multimodal_eeg_fmri_tpu_torch.core import cache as t_cache
from multimodal_eeg_fmri_tpu_torch.core import rng as t_rng
from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.models.eeg import (
    TriModalFusionNetV4Lite as TLite,
)
from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention
from multimodal_eeg_fmri_tpu_torch.ops import _kernels
from multimodal_eeg_fmri_tpu_torch.ops import losses as t_losses

import test_torch_port_cv as cv_tests

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
j_cv = importlib.import_module("multimodal_eeg_fmri_tpu.train.cv")
t_cv = importlib.import_module("multimodal_eeg_fmri_tpu_torch.train.cv")

REPO = Path(__file__).resolve().parent.parent
LITE = dict(hidden_dim=16, dropout=0.0)
T, ROWS = 32, 6
LOSS_ATOL, GRAD_ATOL, JAX_ATOL = 1e-5, 1e-4, 2e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(n, seed=0):
    return dict(erp=_x(n, T, 18, seed=seed), pw=_x(n, T, 75, seed=seed + 1),
                conn=_x(n, 459, seed=seed + 2))


def _seeded(fmod, inputs, seed):
    """Flax variables of ``fmod`` (structure from ``eval_shape``, no init
    compile) filled from a seed: kernels N(0, 1/fan_in), norm scales near
    1, biases and means near 0, variances in [0.5, 1.5]."""
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

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _loss_fn(model):
    """The train-mode loss of ``model`` with its parameters and buffers as
    inputs, and the model's output beside it."""
    def loss(params, buffers, inputs, label):
        out = functional_call(model, {**params, **buffers}, (), inputs)
        return t_losses.cross_entropy(out.logits, label), out
    return loss


def _args(model, inputs, label):
    model.train()
    params = {k: p.detach().clone().requires_grad_()
              for k, p in model.named_parameters()}
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    return (params, buffers, {k: torch.from_numpy(v) for k, v in
                              inputs.items()}, torch.from_numpy(label))


def _run(fn, args):
    """(loss, output, updated buffers, gradients) of ``fn`` on fresh copies
    of the buffers."""
    params, buffers, inputs, label = args
    buffers = {k: b.clone() for k, b in buffers.items()}
    loss, out = fn(params, buffers, inputs, label)
    # a parameter the forward does not reach gets a zero gradient
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return loss, out, buffers, dict(zip(params, grads))


def _assert_same(a, b):
    loss_a, out_a, buf_a, grad_a = a
    loss_b, out_b, buf_b, grad_b = b
    assert torch.equal(loss_a, loss_b)
    assert type(out_a) is type(out_b) is ModelOutput
    for x, y in zip(out_a, out_b):
        assert (x is None and y is None) or torch.equal(x, y)
    for k in buf_b:
        assert torch.equal(buf_a[k], buf_b[k]), k
    for k in grad_b:
        assert torch.equal(grad_a[k], grad_b[k]), k


# --- export_jitted / load_bundle ---------------------------------------------

LOAD_IN_A_FRESH_PROCESS = """
import sys, torch
torch.set_num_threads(1)
from multimodal_eeg_fmri_tpu_torch.core.aot import load_bundle
bundle, args_path, out_path = sys.argv[1:]
params, buffers, inputs, label = torch.load(args_path)
fn = load_bundle(bundle)
loss, out = fn(params, buffers, inputs, label)
grads = torch.autograd.grad(loss, list(params.values()),
                            materialize_grads=True)
torch.save((loss.detach(), tuple(out), buffers,
            dict(zip(params, grads)), "jax" in sys.modules), out_path)
"""


def test_lite_loss_bundle_round_trips_and_matches_jax(tmp_path):
    inputs = _inputs(ROWS, seed=4)
    label = np.array([0, 1, 1, 0, 1, 0])
    variables = _seeded(JLite(**LITE), inputs, seed=1)
    model = load_flax_variables(TLite(**LITE, device="cpu"),
                                variables["params"], variables["batch_stats"])
    loss = _loss_fn(model)
    args = _args(model, inputs, label)
    path = tmp_path / "lite.pt2"
    blob = aot.export_jitted(loss, args, path)
    assert path.stat().st_size == len(blob) > 10_000
    assert json.loads(Path(f"{path}.types.json").read_text()) == [
        "multimodal_eeg_fmri_tpu_torch.models.eeg.ModelOutput"]

    live = _run(loss, args)
    _assert_same(_run(aot.load_bundle(path), args), live)
    _assert_same(_run(aot.load_bundle(blob), args), live)

    # a fresh process: no model built, only the bundle and the arguments
    args_path, out_path = tmp_path / "args.pt", tmp_path / "out.pt"
    torch.save(tuple(args), args_path)
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_IN_A_FRESH_PROCESS, str(path),
         str(args_path), str(out_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    loss_f, out_f, buf_f, grad_f, jax_loaded = torch.load(out_path)
    assert not jax_loaded
    _assert_same((loss_f, ModelOutput(*out_f), buf_f, grad_f),
                 (live[0].detach(), *live[1:]))

    # the JAX package's loss and gradients from the same variables
    def loss_j(params):
        out, mut = JLite(**LITE).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            **{k: jnp.asarray(v) for k, v in inputs.items()}, train=True,
            mutable=["batch_stats"])
        return j_losses.cross_entropy(out.logits,
                                      jnp.asarray(label)), mut["batch_stats"]

    (value_j, stats_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(variables["params"])
    np.testing.assert_allclose(live[0].item(), float(value_j), atol=LOSS_ATOL)
    want = load_flax_variables(TLite(**LITE, device="cpu"),
                               jax.tree.map(np.asarray, grads_j),
                               jax.tree.map(np.asarray, stats_j)).state_dict()
    for name, got in live[3].items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
    for name, got in live[2].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       atol=GRAD_ATOL, rtol=0, err_msg=name)


def _flash_v4():
    model = cv_tests._tri()
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "flash"
    return model


def test_flash_graph_and_registered_backward(tmp_path, monkeypatch):
    model = _flash_v4()
    layers = sum(isinstance(m, MultiHeadAttention) for m in model.modules())
    inputs = _inputs(4, seed=9)
    args = _args(model, inputs, np.array([0, 1, 1, 0]))
    loss = _loss_fn(model)
    aot.export_jitted(loss, args, tmp_path / "v4.pt2")
    program = torch.export.load(tmp_path / "v4.pt2")
    nodes = [n for n in program.graph.nodes
             if str(n.target) == "mmef.flash_fwd.default"]
    assert len(nodes) == layers == 3
    live = _run(loss, args)
    calls = []
    real = port_attn._flash_backward
    monkeypatch.setattr(port_attn, "_flash_backward",
                        lambda *a: (calls.append(a[0].shape), real(*a))[1])
    monkeypatch.setattr(port_attn._FlashAttention, "backward", None)
    got = _run(aot.load_bundle(tmp_path / "v4.pt2"), args)
    assert len(calls) == layers
    _assert_same(got, live)


@pytest.mark.parametrize("case", ["out", "out_and_lse", "expanded"])
def test_operator_gradient_is_flash_attentions_and_jaxs(case):
    r = np.random.default_rng(5)
    q, k, v = (r.standard_normal(s, dtype=np.float32) for s in
               ((2, 2, 20, 16), (2, 2, 27, 16), (2, 2, 27, 16)))
    g = r.standard_normal((2, 2, 20, 16), dtype=np.float32)
    g_lse = r.standard_normal((2, 2, 20), dtype=np.float32)

    def grads(attend):
        x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out, lse = attend(*x)
        if case == "expanded":     # autograd hands over a stride-0 cotangent
            total = out.sum()
        else:
            total = (out * torch.from_numpy(g)).sum()
        if case == "out_and_lse":
            total = total + (lse * torch.from_numpy(g_lse)).sum()
        return (out.detach(), lse.detach(),
                *torch.autograd.grad(total, x))

    op = grads(lambda *x: port_attn.flash_fwd_op(*x, False))
    fa = grads(lambda *x: port_attn._FlashAttention.apply(*x, False))
    for a, b in zip(op, fa):
        assert torch.equal(a, b)

    def loss_j(q, k, v):
        out, lse = jax_attn.flash_attention_lse(q, k, v, interpret=True)
        total = jnp.sum(out) if case == "expanded" else jnp.sum(out * g)
        if case == "out_and_lse":
            total = total + jnp.sum(lse * g_lse)
        return total

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, w in zip(op[2:], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=JAX_ATOL,
                                   rtol=0)


# --- bundle_or_jit ----------------------------------------------------------

def _affine(batch, w):
    return {"y": batch["x"] @ w, "n": batch["x"].sum(0)}


def _affine_args(rows, cols=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"x": torch.randn(rows, 3, generator=g)},
            torch.randn(3, cols, generator=g))


def test_bundle_or_jit_miss_hit_and_key(tmp_path, monkeypatch):
    args = _affine_args(5)
    fn = aot.bundle_or_jit(_affine, args, tmp_path, "tag", batch_args=(0,))
    assert fn is _affine                       # a miss: the live function
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 and files[0].endswith(".pt2")
    assert files[1] == files[0] + ".types.json"

    loads = []
    real = aot.load_bundle
    monkeypatch.setattr(aot, "load_bundle",
                        lambda p: (loads.append(p), real(p))[1])
    hit = aot.bundle_or_jit(_affine, args, tmp_path, "tag", batch_args=(0,))
    assert loads and sorted(p.name for p in tmp_path.iterdir()) == files
    for rows in (5, 9):                        # any row count in ROWS
        a = _affine_args(rows, seed=rows)
        got, want = hit(*a), _affine(*a)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k

    key = aot.bundle_key(args, "tag", (0,))
    assert aot.bundle_key(_affine_args(9, seed=3), "tag", (0,)) == key
    assert aot.bundle_key(_affine_args(1), "tag", (0,)) != key
    assert aot.bundle_key(_affine_args(5, cols=4), "tag", (0,)) != key
    assert aot.bundle_key(args, "other", (0,)) != key
    assert aot.bundle_key(args, "tag", ()) != key
    assert (aot.bundle_key(args, "<f at 0x7f12ab>", (0,))
            == aot.bundle_key(args, "<f at 0x55cd01>", (0,)))


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_manifest_names_the_types_a_bundle_needs(tmp_path):
    path = tmp_path / "pair.pt2"
    x = torch.arange(6.0).reshape(2, 3)
    aot.export_jitted(lambda p: _Pair(p.a * 2, p.b + 1), (_Pair(x, x),), path)
    sidecar = Path(f"{path}.types.json")
    assert json.loads(sidecar.read_text()) == [f"{__name__}._Pair"]
    out = aot.load_bundle(path)(_Pair(x, x))
    assert isinstance(out, _Pair) and torch.equal(out.a, 2 * x)
    sidecar.write_text(json.dumps([f"{__name__}._Pair", "no.such.Type"]))
    with pytest.raises(RuntimeError, match="not registered in this process"):
        aot.load_bundle(path)


# --- run_cv(aot_dir=...) ----------------------------------------------------

@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    """JAX's ``run_cv(aot_dir=...)`` (a miss), and the port's run of the
    same folds without ``aot_dir``, with one (a miss) and again (a hit)."""
    with cv_tests.flax_dropout_off():
        data = cv_tests._eeg_data()
        cfg = cv_tests._cfg(cv_tests.JTrainConfig, 1)
        splits = j_cv.eeg_kfold_splits(data, cfg, n_splits=3)
        bsz = cv_tests._padded_train_rows(data, splits, cv_tests.EEG_KEYS)
        cfg = dataclasses.replace(cfg, batch_size=bsz)
        jax_dir = tmp_path_factory.mktemp("jax_aot")
        res_j = j_cv.run_cv(cv_tests.JTri(**cv_tests.TRI), cfg, data, splits,
                            normalize_keys=cv_tests.EEG_KEYS,
                            aot_dir=str(jax_dir))
        stacks = j_cv.build_fold_arrays(data, splits, "scalar",
                                        cv_tests.EEG_KEYS)
        variables = cv_tests._fold_variables(cv_tests.JTri(**cv_tests.TRI),
                                             cfg.seed, stacks[0], bsz)
    port_dir = tmp_path_factory.mktemp("port_aot")
    t_cfg = cv_tests._port_cfg(cfg)
    t_splits = t_cv.eeg_kfold_splits(data, t_cfg, n_splits=3)
    loads = []
    real = aot.load_bundle

    def run(aot_dir):
        return t_cv.run_cv(_flash_v4(), t_cfg, data, t_splits,
                           normalize_keys=cv_tests.EEG_KEYS,
                           initial_variables=variables, aot_dir=aot_dir)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "load_bundle", lambda p: (loads.append(p),
                                                  real(p))[1])
        plain = run(None)
        miss = run(str(port_dir))
        bundles = sorted(port_dir.glob("*.pt2"))
        loads_after_miss = len(loads)
        hit = run(str(port_dir))
    return dict(jax=res_j, jax_bundles=list(jax_dir.glob("*.shlo")),
                plain=plain, miss=miss, hit=hit, bundles=bundles,
                bundles_after=sorted(port_dir.glob("*.pt2")),
                loads=(loads_after_miss, len(loads)))


def _equal_results(a, b):
    assert a.fold_metrics.keys() == b.fold_metrics.keys()
    for k in b.fold_metrics:
        np.testing.assert_array_equal(a.fold_metrics[k], b.fold_metrics[k])
    for k in b.history:
        np.testing.assert_array_equal(a.history[k], b.history[k])
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k
    np.testing.assert_array_equal(a.test_probs, b.test_probs)
    np.testing.assert_array_equal(a.best_epochs, b.best_epochs)


def test_run_cv_aot_dir_equals_the_run_without_it(cv_runs):
    assert len(cv_runs["bundles"]) == 1          # val and test: one bundle
    assert cv_runs["bundles_after"] == cv_runs["bundles"]
    assert cv_runs["loads"][0] == 0 and cv_runs["loads"][1] >= 1
    _equal_results(cv_runs["miss"], cv_runs["plain"])
    _equal_results(cv_runs["hit"], cv_runs["plain"])


def test_run_cv_aot_dir_matches_jaxs(cv_runs):
    assert len(cv_runs["jax_bundles"]) == 1
    res_j = cv_runs["jax"]
    for res_t in (cv_runs["miss"], cv_runs["hit"]):
        cv_tests._same_history_and_metrics(res_t, res_j)
        cv_tests._close(res_t.test_probs, res_j.test_probs, "test_probs")


# --- enable_compilation_cache -----------------------------------------------

@pytest.fixture
def fresh_cache(monkeypatch):
    """The cache as a fresh process has it: nothing fixed, the library not
    loaded, no environment variable."""
    monkeypatch.setattr(_kernels, "_build_dir_fixed", False)
    monkeypatch.setattr(_kernels, "_build_dir", _kernels.BUILD_DIR)
    monkeypatch.delenv(t_cache.CACHE_DIR_ENV, raising=False)
    _kernels.library.cache_clear()
    yield monkeypatch
    monkeypatch.undo()
    _kernels.library.cache_clear()


def test_compilation_cache_fixes_the_build_directory(fresh_cache, tmp_path):
    d = tmp_path / "kernels"
    assert t_cache.enable_compilation_cache(str(d)) == str(d)
    assert d.is_dir() and _kernels.build_dir() == d
    assert _kernels.library_path().parent == d
    # idempotent: the first call fixed it
    assert t_cache.enable_compilation_cache(str(tmp_path / "other")) == str(d)


def test_compilation_cache_default_and_environment(fresh_cache, tmp_path):
    assert t_cache.enable_compilation_cache() == str(_kernels.BUILD_DIR)
    fresh_cache.setattr(_kernels, "_build_dir_fixed", False)
    fresh_cache.setenv(t_cache.CACHE_DIR_ENV, str(tmp_path / "env"))
    assert t_cache.enable_compilation_cache() == str(tmp_path / "env")
    assert _kernels.build_dir() == tmp_path / "env"


def test_compilation_cache_keeps_a_loaded_library(fresh_cache, tmp_path):
    """Once the library is loaded, a first call keeps it and returns the
    directory it came from."""
    fresh_cache.setattr(_kernels, "build", lambda: _kernels.BUILD_DIR / "x")
    fresh_cache.setattr(_kernels.ctypes, "CDLL", lambda path: None)
    with pytest.raises(AttributeError):      # no entry points on None
        _kernels.library()
    fresh_cache.setattr(_kernels, "library", _Loaded())
    assert (t_cache.enable_compilation_cache(str(tmp_path))
            == str(_kernels.BUILD_DIR))


class _Loaded:
    """A loaded ``library`` as ``use_build_dir`` sees it."""

    def cache_info(self):
        return type("Info", (), {"currsize": 1})()


FAKE_NVCC = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if sys.argv[1:] == ["--version"]:
    print("stand-in nvcc, release 0.0")
else:
    out = sys.argv[sys.argv.index("-o") + 1]
    open(out, "wb").write(b"stand-in")
"""

BUILD_WITH_CACHE = """
import sys
from multimodal_eeg_fmri_tpu_torch.core.cache import enable_compilation_cache
from multimodal_eeg_fmri_tpu_torch.ops import _kernels
enable_compilation_cache(sys.argv[1])
print(_kernels.build())
"""


def test_second_process_loads_without_nvcc(tmp_path):
    """Two processes with the same cache directory and a stand-in toolkit
    whose nvcc records every call: the first asks its version, compiles
    every source and links; the second finds the library and starts nvcc
    only to ask its version (the library's name carries it)."""
    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    cache_dir = tmp_path / "cache"
    env = {**os.environ, "CUDA_HOME": str(toolkit),
           "PYTHONPATH": str(REPO)}
    built = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", BUILD_WITH_CACHE,
                               str(cache_dir)], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        built.append(proc.stdout.strip())
        if len(built) == 1:
            calls = log.read_text().splitlines()
    assert built[0] == built[1]
    assert Path(built[0]).parent == cache_dir and Path(built[0]).is_file()
    units = len(list(_kernels.CSRC.glob("*.cu")))
    assert calls[0] == "--version"
    assert sum(" -c " in f" {c} " for c in calls) == units
    assert len(calls) == units + 2             # the compiles and the link
    # the second process: its version, no compile, no link
    assert log.read_text().splitlines() == calls + ["--version"]


# --- training_key -----------------------------------------------------------

def test_training_key_streams():
    draw = lambda g: torch.rand(1000, generator=g)   # noqa: E731
    a, b = t_rng.training_key(3, "cpu"), t_rng.training_key(3, "cpu")
    assert torch.equal(draw(a), draw(b))             # determinism
    first = draw(t_rng.training_key(3, "cpu"))
    for other in (t_rng.training_key(4, "cpu"), t_rng.generator(3)):
        # independent streams: not equal, and uncorrelated
        x = draw(other)
        assert not torch.equal(first, x)
        assert abs(float(torch.corrcoef(torch.stack([first, x]))[0, 1])) < 0.1
    assert t_rng.training_key(3, "cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_rng.training_key(3)


def test_prebuilt_library_loads_with_no_nvcc(tmp_path):
    """A process with no nvcc (no CUDA_HOME, nothing on PATH) finds the
    library that a stand-in toolkit built into the cache directory."""
    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True)
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     log=str(tmp_path / "nvcc.log")))
    nvcc.chmod(0o755)
    cache_dir = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    built = []
    for extra in ({"CUDA_HOME": str(toolkit)}, {"PATH": ""}):
        proc = subprocess.run([sys.executable, "-c", BUILD_WITH_CACHE,
                               str(cache_dir)], cwd=tmp_path,
                              env={**env, "PYTHONPATH": str(REPO), **extra},
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        built.append(proc.stdout.strip())
    assert built[0] == built[1] and Path(built[1]).is_file()


def test_no_nvcc_refuses_two_toolkits_libraries(fresh_cache, tmp_path):
    """With no nvcc, one library for these sources is loaded and two (from
    two toolkits) raise; a library of other sources is never taken."""
    fresh_cache.setattr(_kernels, "nvcc_version", lambda: "none")
    t_cache.enable_compilation_cache(str(tmp_path))
    missing = _kernels.library_path()
    assert not missing.exists()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    stem = missing.name.rsplit("_", 1)[0]
    (tmp_path / "libmmef_kernels_0123456789abcdef_00000000.so").touch()
    assert _kernels.library_path() == missing
    (tmp_path / f"{stem}_11111111.so").touch()
    assert _kernels.build() == tmp_path / f"{stem}_11111111.so"
    (tmp_path / f"{stem}_22222222.so").touch()
    with pytest.raises(RuntimeError, match="different toolkits"):
        _kernels.library_path()
