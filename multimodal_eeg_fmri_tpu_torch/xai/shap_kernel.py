"""Kernel SHAP with device-batched coalition evaluation (PyTorch).
Counterpart of ``multimodal_eeg_fmri_tpu/xai/shap_kernel.py``: the host
estimator (numpy) is copied, so that both packages draw the same coalitions
from the same ``np.random.Generator``; ``make_class_prob_fn`` evaluates on
the model's device.

Reference: ``SHAPExplainer`` (``eeg_xai_analysis.py:243-365``) and the bridge
SHAP pass (``_test_bridge.py:1159-1247``) wrap ``shap.KernelExplainer`` over
the flattened, concatenated modalities and keep class-1 values. Kernel SHAP
is inherently a host-orchestrated sampling algorithm; this version keeps
the *estimator* on host (tiny weighted least squares) but evaluates ALL
sampled coalitions for ALL explained samples as one batched device call —
the model-evaluation cost, which dominates, becomes a single large batch.

Implementation = the Kernel SHAP algorithm (Lundberg & Lee 2017): sample
coalitions z ∈ {0,1}^M with the Shapley kernel weight
w(z) = (M−1) / (C(M,|z|)·|z|·(M−|z|)), evaluate f(h(z)) where h substitutes
background values for absent features, and solve the constrained weighted
regression whose coefficients are the Shapley values.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.xai.attribution import make_apply_fn


def _coalition_enumerate(m: int):
    """ALL 2^M − 2 proper coalitions with their exact Shapley kernel
    weights w(z) = (M−1)/(C(M,|z|)·|z|·(M−|z|)). With complete enumeration
    the constrained WLS solution EQUALS the Shapley values (Lundberg & Lee
    2017, Thm 2) — used for small M and as the oracle path."""
    from itertools import combinations
    from math import comb

    rows, weights = [], []
    for s in range(1, m):
        w = (m - 1) / (comb(m, s) * s * (m - s))
        for idx in combinations(range(m), s):
            z = np.zeros(m, np.float32)
            z[list(idx)] = 1.0
            rows.append(z)
            weights.append(w)
    return np.stack(rows), np.asarray(weights, np.float64)


def _coalition_sample(m: int, n_samples: int, rng: np.random.Generator):
    """Sample coalitions + kernel weights, always including the paired
    complement (variance reduction, as shap's sampler does)."""
    sizes = np.arange(1, m)
    # shapley kernel over sizes (up to the C(M,s) factor handled by sampling)
    w_sizes = (m - 1) / (sizes * (m - sizes))
    p = w_sizes / w_sizes.sum()
    Z = np.zeros((n_samples, m), np.float32)
    for i in range(0, n_samples, 2):
        s = rng.choice(sizes, p=p)
        idx = rng.choice(m, size=s, replace=False)
        Z[i, idx] = 1.0
        if i + 1 < n_samples:
            Z[i + 1] = 1.0 - Z[i]
    return Z


def kernel_shap(
    f: Callable[[np.ndarray], np.ndarray],
    X: np.ndarray,           # (N, M) samples to explain (flattened features)
    background: np.ndarray,  # (M,) or (Nb, M) background values
    n_samples: int = 100,
    rng: Optional[np.random.Generator] = None,
    batch_eval: bool = True,
    exact: bool = False,
) -> np.ndarray:
    """Shapley values (N, M) for scalar model output ``f`` (e.g. class-1
    probability). ``f`` receives a (K, M) array and returns (K,) — it should
    be a device function (``make_class_prob_fn``); all N·n_samples coalition
    evaluations are issued as one call when ``batch_eval``.

    ``exact=True`` enumerates all 2^M − 2 coalitions with explicit Shapley
    kernel weights — the result is the exact Shapley values for any model
    (feasible for M ≲ 16; 2^M model rows per explained sample).
    """
    rng = rng or np.random.default_rng(0)
    N, M = X.shape
    bg = background.reshape(-1, M).mean(axis=0)

    if exact:
        Z, w = _coalition_enumerate(M)                 # (S, M), (S,)
        S = Z.shape[0]
    else:
        Z = _coalition_sample(M, n_samples, rng)       # (S, M)
        S = Z.shape[0]
        # Coalition SIZES are sampled proportional to the Shapley kernel
        # weight, so the sampling distribution already encodes the kernel
        # (importance sampling, as shap's KernelExplainer does) — the WLS
        # weights must be UNIFORM; re-applying the kernel would square it.
        w = np.ones(S, np.float64)

    # masked inputs for every (sample, coalition): x·z + bg·(1−z)
    Xz = X[:, None, :] * Z[None] + bg[None, None, :] * (1 - Z)[None]  # (N,S,M)
    flat = Xz.reshape(N * S, M)
    fx = np.asarray(f(X)).reshape(N)                   # full coalitions
    f0 = float(np.asarray(f(bg[None, :])).reshape(1)[0])  # empty coalition
    if batch_eval:
        fz = np.asarray(f(flat)).reshape(N, S)
    else:
        fz = np.stack([np.asarray(f(Xz[i])).reshape(S) for i in range(N)])

    # constrained weighted least squares per sample:
    # minimize Σ w_s (f(z_s) − f0 − z_s·φ)²  s.t.  Σφ = fx − f0
    # eliminate the constraint by substituting the last feature; solve with
    # minimum-norm lstsq (the system is underdetermined when n_samples < M,
    # e.g. high-dimensional flattened-modal inputs). The left-hand side is
    # the SAME for every explained sample — only the rank-1
    # ``Z[:,-1]·total_i`` term of the RHS differs — so all N solves share
    # one factorization as a single multi-RHS lstsq (one SVD of (S, M−1)
    # instead of N of them; at EEG scale M ~ 2·10⁴ flattened features the
    # per-sample loop was the estimator's actual bottleneck).
    Zl = Z[:, :-1] - Z[:, -1:]                        # (S, M-1)
    sw = np.sqrt(w)
    A = Zl * sw[:, None]
    total = fx - f0                                    # (N,)
    Yw = sw[:, None] * (fz.T - f0 - Z[:, -1:] * total[None, :])  # (S, N)
    phi_rest, *_ = np.linalg.lstsq(A, Yw, rcond=None)  # (M-1, N)
    phis = np.empty((N, M), np.float32)
    phis[:, :-1] = phi_rest.T
    phis[:, -1] = total - phi_rest.sum(axis=0)
    return phis


def make_class_prob_fn(model, params, batch_stats, template: dict,
                       class_idx: int = 1) -> Callable:
    """Adapter: flattened (K, M) feature rows → class probability, where M is
    the concatenation of the (flattened) modality arrays in ``template``
    (dict of per-modality shapes, insertion-ordered) — the reference's
    flattened-concat SHAP convention. The function runs in eval mode under
    ``torch.no_grad`` on the model's device, all K rows as one batch, and
    returns a float32 numpy array."""
    apply_fn = make_apply_fn(model, params, batch_stats)
    keys = list(template.keys())
    shapes = [tuple(template[k]) for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.cumsum([0] + sizes)

    def apply_flat(x) -> np.ndarray:
        flat = torch.as_tensor(np.asarray(x, np.float32),
                               device=apply_fn.device)
        inputs = {}
        for k, sh, o, s in zip(keys, shapes, offsets[:-1], sizes):
            inputs[k] = flat[:, o:o + s].reshape((flat.shape[0],) + sh)
        with torch.no_grad():
            logits = apply_fn(inputs)
        probs = torch.softmax(logits.float(), dim=-1)[:, class_idx]
        return probs.cpu().numpy()

    return apply_flat
