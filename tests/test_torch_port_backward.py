"""The port's flash-attention gradients against the JAX package's.

The JAX side differentiates its Pallas kernels in interpret mode, as its own
tests do (``jax.vjp``). On the CPU the port's ``flash_attention`` and
``flash_attention_lse`` are autograd Functions whose backward is
``flash_backward_plain``, the math of the two backward kernels, Δ fold
included; the kernels themselves are held to it on the card by
``tests/test_torch_port_kernel.py``. Tolerances: f32 gradients within 1e-5
(sums taken in another order); the bf16-operand mode within 1e-3 of the JAX
package's bf16-operand gradients (the same roundings, sums in another
order), and within 5e-2 of the f32 gradients, the JAX package's own
tolerance for that mode (``tests/test_attention.py``). In bf16 storage
(bf16 q, k, v and dO, f32 operands) the gradients are bf16 and are held
element by element to the JAX package's program compiled without excess
precision: at most 0.1% of them differ (measured 0.03%; Δ summed as f32,
not rounded to bf16 as the JAX package rounds it, made 12-18% differ).
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


@pytest.mark.parametrize("case", CASES)
def test_bf16_operand_grads_match_jax_bf16_operands(case):
    """Both sides in the bf16-operand mode: q, k, v, dO and dS rounded to
    bf16 before their products, P before dV, sums in f32. A rounding put in
    the wrong place (dS left unrounded before dS·K moves dq by ~1e-3) fails
    here where the 5e-2 test against the f32 gradients would not."""
    q, k, v, g, _ = _inputs(*case, seed=6)
    _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention(
        q, k, v, interpret=True, compute_dtype=jnp.bfloat16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = _port_grads(lambda q, k, v: port_attn.flash_attention(
        q, k, v, compute_dtype=torch.bfloat16), q, k, v, (g,))
    _assert_grads(got, want, 1e-3)


@pytest.mark.parametrize("case", CASES)
def test_bf16_storage_grads_match_jax(case):
    """bf16 q, k, v and dO with f32 operands, the mixed-precision fit's
    flash layers: Δ = Σ dO ⊙ O is rounded to bf16 on both sides."""
    q, k, v, g, _ = (x.astype(jnp.bfloat16) for x in map(jnp.asarray,
                                                          _inputs(*case,
                                                                  seed=7)))

    def grads(q, k, v, g):
        _, vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention(
            q, k, v, interpret=True), q, k, v)
        return vjp(g)

    want = jax.jit(grads).lower(q, k, v, g).compile(
        compiler_options={"xla_allow_excess_precision": False})(q, k, v, g)
    leaves = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
              for x in (q, k, v, g)]
    qkv = [x.requires_grad_() for x in leaves[:3]]
    got = torch.autograd.grad(port_attn.flash_attention(*qkv), qkv, leaves[3])
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        differ = (a.float().numpy() != np.asarray(b.astype(jnp.float32)))
        assert differ.mean() <= 1e-3, (name, differ.mean())


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
    # bf16 storage: the product and the sum rounded to bf16, then f32
    ob, gb = torch.from_numpy(o).bfloat16(), torch.from_numpy(g).bfloat16()
    delta = port_attn.flash_delta(ob, gb)
    assert delta.dtype == torch.float32
    assert torch.equal(delta, (ob * gb).sum(-1).float())
    assert torch.equal(delta, delta.bfloat16().float())


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
