"""The port's flash-attention gradients against the JAX package's.

The JAX side differentiates its Pallas kernels in interpret mode, as its own
tests do (``jax.vjp``). On the CPU the port's ``flash_attention`` and
``flash_attention_lse`` are autograd Functions whose backward is
``flash_backward_plain``, the math of the two backward kernels, Δ fold
included; the kernels themselves are held to it on the card by
``tests/test_torch_port_kernel.py``. Tolerances: f32 gradients within 1e-5
(sums taken in another order); the bf16-operand mode within 5e-2 of the f32
gradients, the JAX package's own tolerance for that mode
(``tests/test_attention.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

CASES = [  # (B, H, Tq, Tk, D): Tq != Tk, T not a block multiple, D in {16,32,64}
    (2, 2, 200, 333, 16),
    (1, 2, 130, 70, 32),
    (1, 3, 96, 160, 64),
]


def _inputs(B, H, tq, tk, d, seed=0):
    """q, k, v, the output cotangent g and the lse cotangent g_lse."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, tq, d), dtype=np.float32),
            r.standard_normal((B, H, tk, d), dtype=np.float32),
            r.standard_normal((B, H, tk, d), dtype=np.float32),
            r.standard_normal((B, H, tq, d), dtype=np.float32),
            r.standard_normal((B, H, tq), dtype=np.float32))


def _port_grads(fn, q, k, v, cotangents):
    """Gradients of sum(output · cotangent) through a port function."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cotangents))
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _assert_grads(got, want, atol):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_grads_match_jax(case):
    q, k, v, g, _ = _inputs(*case)
    _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention(
        q, k, v, interpret=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    _assert_grads(_port_grads(port_attn.flash_attention, q, k, v, (g,)),
                  want, 1e-5)


@pytest.mark.parametrize("case", CASES[:2])
def test_flash_attention_lse_grads_match_jax(case):
    """A nonzero lse cotangent folds into Δ on both sides."""
    q, k, v, g, g_lse = _inputs(*case, seed=1)
    _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention_lse(
        q, k, v, interpret=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    _assert_grads(_port_grads(port_attn.flash_attention_lse, q, k, v,
                              (g, g_lse)), want, 1e-5)


def test_bf16_operand_grads_track_f32_reference():
    q, k, v, g, _ = _inputs(2, 2, 200, 333, 64, seed=2)
    _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention(
        q, k, v, interpret=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = _port_grads(lambda q, k, v: port_attn.flash_attention(
        q, k, v, compute_dtype=torch.bfloat16), q, k, v, (g,))
    _assert_grads(got, want, 5e-2)


def test_backward_runs_plain_version_on_cpu(monkeypatch):
    """On CPU tensors autograd reaches ``_flash_backward`` once per
    backward, with the lse cotangent, and no kernel launch is counted."""
    calls = []
    real = port_attn._flash_backward

    def spy(*args):
        calls.append(args[6])
        return real(*args)

    monkeypatch.setattr(port_attn, "_flash_backward", spy)
    q, k, v, g, g_lse = _inputs(1, 2, 40, 300, 16, seed=3)
    before = port_attn.kernel_launches()
    _port_grads(port_attn.flash_attention, q, k, v, (g,))
    _port_grads(port_attn.flash_attention_lse, q, k, v, (g, g_lse))
    assert calls[0] is None
    np.testing.assert_array_equal(calls[1].numpy(), g_lse)
    assert port_attn.kernel_launches() == before


def test_delta_folds_lse_cotangent():
    _, _, _, g, g_lse = _inputs(1, 2, 30, 30, 16, seed=4)
    o = np.random.default_rng(5).standard_normal(g.shape, dtype=np.float32)
    delta = port_attn.flash_delta(torch.from_numpy(o), torch.from_numpy(g),
                                  torch.from_numpy(g_lse))
    assert delta.dtype == torch.float32 and delta.shape == g_lse.shape
    np.testing.assert_allclose(delta.numpy(), (o * g).sum(-1) - g_lse,
                               atol=1e-5, rtol=0)


def test_padded_rows_get_no_gradient():
    """A query row whose lse is +inf has P = 0: its dq is 0 and it adds
    nothing to dk and dv, as in the kernels' masked edge."""
    q, k, v, g, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 6, 9, 16))
    out, lse = port_attn.flash_forward_plain(q, k, v)
    lse[..., -2:] = float("inf")
    dq, dk, dv = port_attn.flash_backward_plain(q, k, v, out, lse, g)
    assert torch.all(dq[..., -2:, :] == 0)
    ref = port_attn.flash_backward_plain(q[..., :-2, :], k, v,
                                         out[..., :-2, :], lse[..., :-2],
                                         g[..., :-2, :])
    torch.testing.assert_close(dk, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, ref[2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("wrapper", ["flash_backward_cuda",
                                     "flash_bwd_dkv_cuda",
                                     "flash_bwd_dq_cuda"])
def test_cuda_backward_wrappers_reject_cpu_tensors(wrapper):
    q, k, v, g, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 16))
    out, lse = port_attn.flash_forward_plain(q, k, v)
    args = ((q, k, v, out, lse, g) if wrapper == "flash_backward_cuda"
            else (q, k, v, g, lse, port_attn.flash_delta(out, g)))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(port_attn, wrapper)(*args)
