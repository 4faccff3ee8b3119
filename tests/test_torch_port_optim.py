"""The port's flat-vector AdamW (``ops/optim.py``) against the JAX
package's (``multimodal_eeg_fmri_tpu/ops/optim.py``) and against
``torch.optim.AdamW``.

The same numpy-seeded parameter tree (nested dicts of f32 leaves)
and three steps of seeded gradients go through both packages'
``fused_adamw_step``, with the clip on (at a norm the gradients pass, so
that it scales them) and off: every parameter and both moments within 1e-6
of the tensor's largest element, the step count exact. The same steps with
``torch.optim.AdamW`` on the f32 leaves (the gradients clipped as the
train step clips them, ``train.fit.clip_by_global_norm_``) within 1e-6 of
the largest too, also for a zero-initialised leaf (a bias), which is its
updates alone: there the port's float64 bias corrections, torch's, hold it
within 1e-6 where the JAX package's f32 ones move it by 7e-6, so the JAX
comparison runs on parameters of size 1; ``lr`` and the weight decay as
Python floats and as 0-d tensors give the same result bit for bit; the
inputs are left as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu.ops import optim as j_optim
from multimodal_eeg_fmri_tpu_torch.ops import optim as t_optim
from multimodal_eeg_fmri_tpu_torch.train.fit import clip_by_global_norm_

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

LR, WD, STEPS = 1e-3, 1e-2, 3
RTOL = 1e-6                     # of each tensor's largest element
SHAPES = {"a": (4, 3), "b": {"c": (7,), "d": (2, 5)}}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (scale * r.standard_normal(s)).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    limit = RTOL * np.abs(want).max()
    assert np.abs(got - want).max() <= limit, (what, np.abs(got - want).max(),
                                               limit)


def _runs(clip):
    p0 = _tree(0)
    grads = [_tree(10 + i, 0.5) for i in range(STEPS)]
    pj, sj = jax.tree.map(jnp.asarray, p0), None
    sj = j_optim.init_fused_adamw(pj)
    pt = _torch(p0)
    st = t_optim.init_fused_adamw(pt)
    for g in grads:
        pj, sj = j_optim.fused_adamw_step(pj, jax.tree.map(jnp.asarray, g),
                                          sj, LR, WD, grad_clip=clip)
        pt, st = t_optim.fused_adamw_step(pt, _torch(g), st, LR, WD,
                                          grad_clip=clip)
    return p0, grads, (pj, sj), (pt, st)


@pytest.mark.parametrize("clip", [0.0, 2.0], ids=["no_clip", "clip"])
def test_fused_adamw_matches_jax(clip):
    p0, grads, (pj, sj), (pt, st) = _runs(clip)
    if clip:    # the clip scales every step's gradient
        assert all(np.sqrt(sum(np.sum(x * x) for x in jax.tree.leaves(g)))
                   > clip for g in grads)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(pj),
                                 jax.tree.leaves(pt)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got.numpy(), want, jax.tree_util.keystr(path))
    # the moments: flat in both, in the leaves' order of each package
    # (JAX sorts dict keys, the port keeps insertion order; both equal here)
    _close(st.mu.numpy(), sj.mu, "mu")
    _close(st.nu.numpy(), sj.nu, "nu")
    assert int(st.count) == int(sj.count) == STEPS
    assert st.count.dtype == torch.int32


@pytest.mark.parametrize("clip", [0.0, 2.0], ids=["no_clip", "clip"])
def test_fused_adamw_matches_torch_adamw(clip):
    p0, grads, _, (pt, _) = _runs(clip)
    leaves = [torch.nn.Parameter(torch.from_numpy(x.copy()))
              for x in jax.tree.leaves(p0)]
    opt = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD,
                            betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        for p, x in zip(leaves, jax.tree.leaves(g)):
            p.grad = torch.from_numpy(x.copy())
        if clip:
            clip_by_global_norm_([p.grad for p in leaves], clip)
        opt.step()
    for i, (got, want) in enumerate(zip(jax.tree.leaves(pt), leaves)):
        _close(got.numpy(), want.detach().numpy(), i)


@pytest.mark.parametrize("clip", [0.0, 2.0], ids=["no_clip", "clip"])
def test_zero_initialised_leaf_matches_torch_adamw(clip):
    p0 = {"w": torch.from_numpy(_tree(0)["a"]), "bias": torch.zeros(5)}
    grads = [{"w": torch.from_numpy(_tree(10 + i, 0.5)["a"]),
              "bias": torch.from_numpy(_tree(20 + i, 0.5)["b"]["c"][:5])}
             for i in range(STEPS)]
    pt, st = p0, t_optim.init_fused_adamw(p0)
    leaves = [torch.nn.Parameter(x.clone()) for x in p0.values()]
    opt = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD,
                            betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        pt, st = t_optim.fused_adamw_step(pt, g, st, LR, WD, grad_clip=clip)
        for p, x in zip(leaves, g.values()):
            p.grad = x.clone()
        if clip:
            clip_by_global_norm_([p.grad for p in leaves], clip)
        opt.step()
    for (name, got), want in zip(pt.items(), leaves):
        _close(got.numpy(), want.detach().numpy(), name)


def test_fused_adamw_runtime_scalars_and_mixed_dtypes():
    """``lr`` and the weight decay as 0-d tensors give the floats' result
    bit for bit; a list node and a bf16 leaf round-trip (the flat vector
    is f32, the leaf comes back bf16); the inputs are not modified."""
    params = {"w": [torch.randn(3, 2, generator=torch.Generator()
                                .manual_seed(0)),
                    torch.ones(4, dtype=torch.bfloat16)]}
    grads = {"w": [torch.full((3, 2), 0.1), torch.full((4,), 0.2,
                                                       dtype=torch.bfloat16)]}
    kept = [t.clone() for t in params["w"]]
    state = t_optim.init_fused_adamw(params)
    assert state.mu.dtype == torch.float32 and state.mu.shape == (10,)
    a, sa = t_optim.fused_adamw_step(params, grads, state, LR, WD, 1.0)
    b, sb = t_optim.fused_adamw_step(params, grads, state, torch.tensor(LR),
                                     torch.tensor(WD), 1.0)
    for x, y in zip(a["w"], b["w"]):
        assert torch.equal(x, y)
    assert torch.equal(sa.mu, sb.mu) and torch.equal(sa.nu, sb.nu)
    assert a["w"][1].dtype == torch.bfloat16
    for x, y in zip(params["w"], kept):
        assert torch.equal(x, y)
    assert int(state.count) == 0 and int(sa.count) == 1
