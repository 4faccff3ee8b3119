"""Flash attention at head dims between the kernel instances (fault C9).

K1-K3 are built for D ∈ (16, 32, 64, 128). The HPO space's hidden widths
and head counts give head dims such as 8, 12, 24 and 48, which the
``*_cuda`` wrappers zero-pad to the next instance, passing the kernel the
true scale 1/√d. Here, on the CPU: the plain versions at the padded width
with the true scale, sliced back, equal the plain versions at d within 1e-6
(the zero columns add nothing; only the sums' blocking may differ), forward
and backward, in f32 and bf16 storage; and the port's ``flash_attention``
equals the JAX package's (its Pallas kernel in interpret mode, as its own
tests run it, which pads to 128 lanes) at d = 24 and 48 within 2e-5, output
and input gradients. The kernels themselves at these head dims are tested
on the card (``test_torch_port_kernel.py``, marked ``cuda``).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

PADDED = {8: 16, 12: 16, 24: 32, 48: 64}
PAD_ATOL = 1e-6
JAX_ATOL = 2e-5


def _inputs(d, dtype, B=2, H=2, tq=70, tk=90, seed=0):
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.standard_normal(s, dtype=np.float32))
               .to(dtype) for s in ((B, H, tq, d), (B, H, tk, d),
                                    (B, H, tk, d)))
    g = torch.from_numpy(r.standard_normal((B, H, tq, d),
                                           dtype=np.float32)).to(dtype)
    return q, k, v, g


@pytest.mark.parametrize("d,kd", sorted(PADDED.items()))
def test_kernel_head_dim_is_the_next_instance(d, kd):
    assert port_attn.kernel_head_dim(d) == kd
    assert port_attn.kernel_head_dim(kd) == kd
    x = torch.ones(1, 1, 3, d)
    padded = port_attn.pad_head_dim(x, kd)
    assert padded.shape == (1, 1, 3, kd)
    assert torch.equal(padded[..., :d], x) and not padded[..., d:].any()
    assert port_attn.pad_head_dim(padded, kd) is padded


@pytest.mark.parametrize("d", [0, 129, 256])
def test_head_dim_past_the_limit_raises(d):
    with pytest.raises(ValueError, match="128"):
        port_attn.kernel_head_dim(d)


@pytest.mark.parametrize("d", sorted(PADDED))
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-operands", "bf16-operands"])
def test_padded_plain_equals_plain(d, storage, compute_dtype):
    """What the wrappers give the kernels, computed by the plain versions:
    the forward and both backward halves at the padded width with the true
    scale, sliced back to d, against the plain versions at d."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    kd, scale = PADDED[d], 1.0 / math.sqrt(d)
    q, k, v, g = _inputs(d, dtype)
    pq, pk, pv, pg = (port_attn.pad_head_dim(t, kd) for t in (q, k, v, g))

    out, lse = port_attn.flash_forward_plain(q, k, v, compute_dtype)
    out_p, lse_p = port_attn.flash_forward_plain(pq, pk, pv, compute_dtype,
                                                 scale=scale)
    assert out_p.shape[-1] == kd and not out_p[..., d:].float().any()
    np.testing.assert_allclose(out_p[..., :d].float().numpy(),
                               out.float().numpy(), atol=PAD_ATOL, rtol=0)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), atol=PAD_ATOL,
                               rtol=0)

    delta = port_attn.flash_delta(out, g)
    dk, dv = port_attn.flash_bwd_dkv_plain(q, k, v, g, lse, delta,
                                           compute_dtype)
    dq = port_attn.flash_bwd_dq_plain(q, k, v, g, lse, delta, compute_dtype)
    dk_p, dv_p = port_attn.flash_bwd_dkv_plain(pq, pk, pv, pg, lse, delta,
                                               compute_dtype, scale=scale)
    dq_p = port_attn.flash_bwd_dq_plain(pq, pk, pv, pg, lse, delta,
                                        compute_dtype, scale=scale)
    for name, got, want in (("dk", dk_p, dk), ("dv", dv_p, dv),
                            ("dq", dq_p, dq)):
        assert not got[..., d:].float().any(), name
        np.testing.assert_allclose(got[..., :d].float().numpy(),
                                   want.float().numpy(), atol=PAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [24, 48])
def test_flash_attention_matches_jax_interpret(d):
    """The port's differentiable ``flash_attention`` (the plain math on
    the CPU) against the JAX package's, whose wrapper pads d to 128 lanes
    with the true scale: output and the gradients of Σ out·g."""
    r = np.random.default_rng(d)
    q, k, v, g = (r.standard_normal(s, dtype=np.float32) for s in
                  ((2, 2, 130, d), (2, 2, 200, d), (2, 2, 200, d),
                   (2, 2, 130, d)))

    def loss_j(q, k, v):
        out = jax_attn.flash_attention(q, k, v, interpret=True)
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_p = port_attn.flash_attention(tq, tk, tv)
    (out_p * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               atol=JAX_ATOL, rtol=0)
    for name, t, gj in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   atol=JAX_ATOL, rtol=0, err_msg=name)
