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
and input gradients. Past 128 the wrappers launch the CUDA-core kernels
(``csrc/flash_wide.cu``) at the true head dim: the routing, and
``flash_attention`` and ``flash_attention_lse`` at d = 160 and 256 against
JAX's interpret mode (which pads to 256 lanes) within 2e-5, outputs, lse
and the gradients with an lse cotangent. The kernels themselves at these
head dims are tested on the card (``test_torch_port_kernel.py``, marked
``cuda``).
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


# --- head dims past 128: the CUDA-core kernels (csrc/flash_wide.cu) --------

WIDE_DIMS = (160, 256)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_head_dim_goes_unpadded_to_the_cuda_core_kernels(d):
    """Past 128 a wrapper launches at the true d through the ``*_wide``
    entry points; past ``WIDE_MAX_HEAD_DIM`` it raises."""
    assert port_attn._launch_head_dim(d) == d
    assert port_attn._launch_head_dim(100) == 128

    class Lib:
        mmef_flash_fwd, mmef_flash_fwd_wide = "mma", "wide"

    assert port_attn._entry(Lib, "mmef_flash_fwd", d) == "wide"
    assert port_attn._entry(Lib, "mmef_flash_fwd", 128) == "mma"
    with pytest.raises(ValueError, match="limit"):
        port_attn._launch_head_dim(port_attn.WIDE_MAX_HEAD_DIM + 1)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("with_lse", [False, True],
                         ids=["flash_attention", "flash_attention_lse"])
def test_wide_head_dim_matches_jax_interpret(d, with_lse):
    """``flash_attention`` and ``flash_attention_lse`` at d = 160 and 256
    (the plain math on the CPU, the functions the wide kernels compute)
    against the JAX package's, whose wrapper pads d to 256 lanes: output
    (and lse) and the gradients of Σ out·g (+ Σ lse·g_lse) within 2e-5."""
    r = np.random.default_rng(d + with_lse)
    q, k, v, g = (r.standard_normal(s, dtype=np.float32) for s in
                  ((2, 2, 70, d), (2, 2, 90, d), (2, 2, 90, d),
                   (2, 2, 70, d)))
    g_lse = r.standard_normal((2, 2, 70), dtype=np.float32)

    def loss_j(q, k, v):
        out, lse = jax_attn.flash_attention_lse(q, k, v, interpret=True)
        total = jnp.sum(out * g) + (jnp.sum(lse * g_lse) if with_lse else 0)
        return total, (out, lse)

    (_, (out_j, lse_j)), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    if with_lse:
        out_p, lse_p = port_attn.flash_attention_lse(tq, tk, tv)
        np.testing.assert_allclose(lse_p.detach().numpy(), np.asarray(lse_j),
                                   atol=JAX_ATOL, rtol=0)
        loss = ((out_p * torch.from_numpy(g)).sum()
                + (lse_p * torch.from_numpy(g_lse)).sum())
    else:
        out_p = port_attn.flash_attention(tq, tk, tv)
        loss = (out_p * torch.from_numpy(g)).sum()
    loss.backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               atol=JAX_ATOL, rtol=0)
    for name, t, gj in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   atol=JAX_ATOL, rtol=0, err_msg=name)
