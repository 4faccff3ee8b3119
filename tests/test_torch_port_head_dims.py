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
and input gradients. Past 128, K1, K2 and K3 pad a head dim in (128, 256]
to the split tensor-core instances 192 and 256 (``csrc/flash_fwd_split.cu``,
``csrc/flash_bwd_split.cu``) with the true scale; past 256 all three take
the deep tensor-core kernels (``csrc/flash_fwd_deep.cu``,
``csrc/flash_bwd_deep.cu``) at the head dim zero-padded to a multiple of
64, with the true scale: the routing, through a stand-in library that
records the launch; the padded plain forward and backward at d = 129, 160
and 224 on their instance and at d = 257, 300 and 320 padded to 320,
against the plain versions at d (1e-6, as above); past the old limit of
12,448, d = 12,449 routed to the deep kernels at 12,480, the grid's bound
refused with ``unsupported sizes``, and ``flash_attention_lse`` at d =
12,480 against JAX's interpret mode at a tiny T (2e-5); ``flash_attention`` and ``flash_attention_lse`` at
d = 160, 256, 320 and 512 against JAX's interpret mode (which pads to a
multiple of 128 lanes) within 2e-5 in f32, outputs, lse and the
gradients with an lse cotangent; in the bf16-operand mode against JAX's
``compute_dtype=bfloat16`` within 2e-3 (outputs, lse) and 1e-3 (gradients),
and in bf16 storage at d = 160, 256 and 320 against JAX's program compiled
without excess precision, at most 0.1% of the bf16 outputs and gradients
differing, the
gates ``test_torch_port_attention.py`` and ``test_torch_port_backward.py``
set at D ≤ 128, and at 512 the output, lse and dV so and every element of
the output and gradients within one bf16 ulp of float64; and one train step of ``LongContextClassifier(
hidden_dim=512, num_heads=2)`` (D = 256) on the flash route against the JAX
package's (its kernel in interpret mode), the loss within 1e-5 and every
gradient within 1e-4 of the largest, as ``test_torch_port_long_context.py``
holds the narrow models. The kernels themselves at these head dims are
tested on the card (``test_torch_port_kernel.py``, marked ``cuda``).
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
# past 128: K1, K2 and K3 on the split tensor-core instances
SPLIT_PADDED = {129: 192, 160: 192, 192: 192, 224: 256, 256: 256}
# past 256: K2 and K3 on the deep kernels, d padded to a multiple of 64
DEEP_PADDED = {257: 320, 300: 320, 320: 320, 512: 512, 1000: 1024}
PAD_ATOL = 1e-6
JAX_ATOL = 2e-5
# the bf16-operand mode against JAX's: outputs and lse, and gradients
# (test_torch_port_attention.py, test_torch_port_backward.py)
JAX_BF16_ATOL, JAX_BF16_GRAD_ATOL = 2e-3, 1e-3
# bf16 storage against JAX's: the share of bf16 elements that may differ
JAX_BF16_STORAGE_DIFFER = 1e-3


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


@pytest.mark.parametrize("d", sorted(PADDED) + [129, 160, 224])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-operands", "bf16-operands"])
def test_padded_plain_equals_plain(d, storage, compute_dtype):
    """What the wrappers give the kernels, computed by the plain versions:
    the forward and both backward halves at the padded width with the true
    scale, sliced back to d, against the plain versions at d (past 128 all
    three are padded to the split instances: 129 and 160 to 192, 224 to
    256)."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    kd = {**PADDED, **SPLIT_PADDED}[d]
    q, k, v, g = _inputs(d, dtype)
    out, lse = _padded_forward_equals_plain(q, k, v, kd, compute_dtype)
    _padded_backward_equals_plain(q, k, v, g, out, lse, kd, compute_dtype)


def _padded_forward_equals_plain(q, k, v, kd, compute_dtype):
    """The forward's plain version at head dim ``kd`` (q, k, v zero-padded)
    with the true scale, sliced back to d, against the plain version at d,
    within PAD_ATOL; the padded columns stay zero. Returns the plain
    version's (out, lse) at d."""
    d, scale = q.shape[-1], 1.0 / math.sqrt(q.shape[-1])
    pq, pk, pv = (port_attn.pad_head_dim(t, kd) for t in (q, k, v))
    out, lse = port_attn.flash_forward_plain(q, k, v, compute_dtype)
    out_p, lse_p = port_attn.flash_forward_plain(pq, pk, pv, compute_dtype,
                                                 scale=scale)
    assert out_p.shape[-1] == kd and not out_p[..., d:].float().any()
    np.testing.assert_allclose(out_p[..., :d].float().numpy(),
                               out.float().numpy(), atol=PAD_ATOL, rtol=0)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), atol=PAD_ATOL,
                               rtol=0)
    return out, lse


def _padded_backward_equals_plain(q, k, v, g, out, lse, kd, compute_dtype):
    """Both backward halves' plain versions at head dim ``kd`` (q, k, v
    and dO zero-padded) with the true scale, sliced back to d, against the
    plain versions at d, within PAD_ATOL; the padded columns stay zero."""
    d, scale = q.shape[-1], 1.0 / math.sqrt(q.shape[-1])
    pq, pk, pv, pg = (port_attn.pad_head_dim(t, kd) for t in (q, k, v, g))
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
        assert got.shape[-1] == kd, name
        assert not got[..., d:].float().any(), name
        np.testing.assert_allclose(got[..., :d].float().numpy(),
                                   want.float().numpy(), atol=PAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [257, 300, 320])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-operands", "bf16-operands"])
def test_deep_padded_plain_equals_plain(d, storage, compute_dtype):
    """What the wrappers give the deep kernels past 256, computed by the
    plain versions: the forward and both backward halves at d padded to a
    multiple of 64 with the true scale, sliced back to d, against the plain
    versions at d."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    q, k, v, g = _inputs(d, dtype)
    kd = port_attn._launch("mmef_flash_fwd", d)[1]
    assert kd == port_attn._launch("mmef_flash_bwd_dq", d)[1] == DEEP_PADDED[d]
    out, lse = _padded_forward_equals_plain(q, k, v, kd, compute_dtype)
    _padded_backward_equals_plain(q, k, v, g, out, lse, kd, compute_dtype)


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


# --- head dims past 128: the split kernels up to 256, then the deep
# tensor-core kernels

WIDE_DIMS = (160, 256, 320, 512)
# past 256: K1 on the deep kernel (csrc/flash_fwd_deep.cu), d padded
DEEP_FORWARD_DIMS = (257, 320)


@pytest.mark.parametrize("d", DEEP_FORWARD_DIMS)
def test_wide_head_dim_goes_padded_to_the_deep_kernel(d):
    """Past 256 K1's wrapper launches through the ``_deep`` entry point at
    d padded to a multiple of 64, as K2 and K3 do
    (``test_backward_routes_by_head_dim``), also past the old limit of
    12,448: 12,449 goes to the deep kernels padded to 12,480. Past the
    grid's bound, ``WIDE_MAX_HEAD_DIM`` (65,535 column slices of 512 on
    the grid's z axis), all three raise ``unsupported sizes``."""
    assert port_attn._launch("mmef_flash_fwd", d) == ("mmef_flash_fwd_deep",
                                                      DEEP_PADDED[d])
    assert port_attn._launch("mmef_flash_fwd", 100) == ("mmef_flash_fwd", 128)
    assert port_attn.WIDE_MAX_HEAD_DIM == 65535 * 512
    for name in ("mmef_flash_fwd", "mmef_flash_bwd_dkv", "mmef_flash_bwd_dq"):
        assert port_attn._launch(name, 12449) == (f"{name}_deep", 12480)
        assert port_attn._launch(name, port_attn.WIDE_MAX_HEAD_DIM) == (
            f"{name}_deep", port_attn.WIDE_MAX_HEAD_DIM)
        with pytest.raises(ValueError, match="unsupported sizes"):
            port_attn._launch(name, port_attn.WIDE_MAX_HEAD_DIM + 1)


def _wide_sizes(d):
    """(B, H, Tq, Tk) of the JAX parity tests at head dim d: past 256 one
    batch row and fewer rows, so that the interpret-mode runs stay small."""
    return (2, 2, 70, 90) if d <= 256 else (1, 2, 40, 70)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("with_lse", [False, True],
                         ids=["flash_attention", "flash_attention_lse"])
def test_wide_head_dim_matches_jax_interpret(d, with_lse):
    """``flash_attention`` and ``flash_attention_lse`` at d = 160, 256, 320
    and 512 (the plain math on the CPU, the functions the split kernels and,
    past 256, the deep kernels compute) against the
    JAX package's, whose wrapper pads d to a multiple of 128 lanes: output
    (and lse) and the gradients of Σ out·g (+ Σ lse·g_lse) within 2e-5."""
    r = np.random.default_rng(d + with_lse)
    B, H, tq, tk = _wide_sizes(d)
    q, k, v, g = (r.standard_normal(s, dtype=np.float32) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))
    g_lse = r.standard_normal((B, H, tq), dtype=np.float32)

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


def test_head_dim_past_the_old_limit_matches_jax_interpret():
    """At d = 12,480, past the old limit of 12,448 (the deep kernels at a
    multiple of 64), ``flash_attention_lse`` against the JAX package's
    interpret mode at a tiny T: output, lse and the gradients of
    Σ out·g + Σ lse·g_lse within 2e-5."""
    d = 12480
    r = np.random.default_rng(d)
    B, H, tq, tk = 1, 1, 6, 10
    q, k, v, g = (r.standard_normal(s, dtype=np.float32) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))
    g_lse = r.standard_normal((B, H, tq), dtype=np.float32)

    def loss_j(q, k, v):
        out, lse = jax_attn.flash_attention_lse(q, k, v, interpret=True)
        return jnp.sum(out * g) + jnp.sum(lse * g_lse), (out, lse)

    (_, (out_j, lse_j)), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_p, lse_p = port_attn.flash_attention_lse(tq_, tk_, tv_)
    ((out_p * torch.from_numpy(g)).sum()
     + (lse_p * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(lse_p.detach().numpy(), np.asarray(lse_j),
                               atol=JAX_ATOL, rtol=0)
    for name, t, gj in zip(("dq", "dk", "dv"), (tq_, tk_, tv_), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   atol=JAX_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("with_lse", [False, True],
                         ids=["flash_attention", "flash_attention_lse"])
def test_wide_head_dim_bf16_operands_match_jax(d, with_lse):
    """The bf16-operand mode at d = 160, 256, 320 and 512 on both sides
    (``compute_dtype=bfloat16``: q, k, p, v, dO and dS rounded to bf16
    before their products, every sum in f32): output and lse within 2e-3,
    the gradients of Σ out·g (+ Σ lse·g_lse) within 1e-3."""
    r = np.random.default_rng(10 * d + with_lse)
    B, H, tq, tk = _wide_sizes(d)
    q, k, v, g = (r.standard_normal(s, dtype=np.float32) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))
    g_lse = r.standard_normal((B, H, tq), dtype=np.float32)

    def loss_j(q, k, v):
        out, lse = jax_attn.flash_attention_lse(q, k, v, interpret=True,
                                                compute_dtype=jnp.bfloat16)
        total = jnp.sum(out * g) + (jnp.sum(lse * g_lse) if with_lse else 0)
        return total, (out, lse)

    (_, (out_j, lse_j)), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_p, lse_p = port_attn.flash_attention_lse(tq, tk, tv,
                                                 compute_dtype=torch.bfloat16)
    loss = (out_p * torch.from_numpy(g)).sum()
    if with_lse:
        loss = loss + (lse_p * torch.from_numpy(g_lse)).sum()
    loss.backward()
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               atol=JAX_BF16_ATOL, rtol=0)
    np.testing.assert_allclose(lse_p.detach().numpy(), np.asarray(lse_j),
                               atol=JAX_BF16_ATOL, rtol=0)
    for name, t, gj in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   atol=JAX_BF16_GRAD_ATOL, rtol=0,
                                   err_msg=name)


# bf16 storage against JAX's element by element up to 320. At 512 both
# packages round Δ = rowsum(dO ⊙ O) to bf16 from outputs that differ by one
# bf16 ulp on 0.07% of their elements: where that moves a row's Δ across a
# rounding boundary (1 or 2 rows of 80 at seeds 519 and 2), P ⊙ Δ moves the
# row's dQ and every column of dK (0.14-0.31% of dQ's elements, 0.69-2.2%
# of dK's). Given its own Δ, each package's dQ and dK lie within 0.53 bf16
# ulp of float64 everywhere; so at 512 the port is held to JAX on the
# output, lse and dV, and to float64 (test below).
BF16_STORAGE_DIMS = (160, 256, 320)


@pytest.mark.parametrize("d", BF16_STORAGE_DIMS)
def test_wide_head_dim_bf16_storage_matches_jax(d):
    """bf16 q, k, v and dO with f32 operands at d = 160, 256 and 320, the
    mixed-precision fit's flash layers, against the JAX package's program
    compiled without excess precision: the bf16 output and gradients equal
    element by element but for at most 0.1% of them, and lse (f32) within
    2e-5."""
    r = np.random.default_rng(d + 7)
    B, H, tq, tk = _wide_sizes(d)
    q, k, v, g = (jnp.asarray(r.standard_normal(s, dtype=np.float32))
                  .astype(jnp.bfloat16) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))

    def run(q, k, v, g):
        (out, lse), vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention_lse(
            q, k, v, interpret=True), q, k, v)
        return out, lse, vjp((g, jnp.zeros_like(lse)))

    out_j, lse_j, grads_j = jax.jit(run).lower(q, k, v, g).compile(
        compiler_options={"xla_allow_excess_precision": False})(q, k, v, g)
    leaves = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
              for x in (q, k, v, g)]
    qkv = [x.requires_grad_() for x in leaves[:3]]
    out_p, lse_p = port_attn.flash_attention_lse(*qkv)
    grads_p = torch.autograd.grad(out_p, qkv, leaves[3])
    np.testing.assert_allclose(lse_p.detach().numpy(), np.asarray(lse_j),
                               atol=JAX_ATOL, rtol=0)
    for a, b, name in zip((out_p, *grads_p), (out_j, *grads_j),
                          ("out", "dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        differ = (a.detach().float().numpy()
                  != np.asarray(b.astype(jnp.float32)))
        assert differ.mean() <= JAX_BF16_STORAGE_DIFFER, (name, differ.mean())


def _bf16_ulps(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|x − ref| in bf16 ulps of ref's elements (2^(⌊log2|ref|⌋ − 7)), an
    ulp no finer than that of 2^-12 of ref's largest |element|."""
    mag = ref.abs().clamp_min(ref.abs().max() * 2.0 ** -12)
    return (x.double() - ref).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                                 - 7)


def test_wide_head_dim_bf16_storage_at_512_against_float64():
    """bf16 storage at d = 512 (``BF16_STORAGE_DIMS`` says why not against
    JAX element by element): the output and dV equal JAX's but for at most
    0.1% of their elements, lse within 2e-5; the port's Δ within one bf16
    ulp of the float64 sum of its bf16 products dO ⊙ O (the rounding both
    packages make); and the port's output, dQ, dK and dV, every element,
    within one bf16 ulp of the float64 result from the same bf16 inputs,
    the backward's from the port's Δ."""
    d = 512
    r = np.random.default_rng(d + 7)
    B, H, tq, tk = _wide_sizes(d)
    q, k, v, g = (jnp.asarray(r.standard_normal(s, dtype=np.float32))
                  .astype(jnp.bfloat16) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))

    def run(q, k, v, g):
        (out, lse), vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention_lse(
            q, k, v, interpret=True), q, k, v)
        return out, lse, vjp((g, jnp.zeros_like(lse)))

    out_j, lse_j, grads_j = jax.jit(run).lower(q, k, v, g).compile(
        compiler_options={"xla_allow_excess_precision": False})(q, k, v, g)
    leaves = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
              for x in (q, k, v, g)]
    qkv = [x.clone().requires_grad_() for x in leaves[:3]]
    out_p, lse_p = port_attn.flash_attention_lse(*qkv)
    grads_p = torch.autograd.grad(out_p, qkv, leaves[3])
    out_p = out_p.detach()
    np.testing.assert_allclose(lse_p.detach().numpy(), np.asarray(lse_j),
                               atol=JAX_ATOL, rtol=0)
    for a, b, name in ((out_p, out_j, "out"), (grads_p[2], grads_j[2], "dv")):
        differ = a.float().numpy() != np.asarray(b.astype(jnp.float32))
        assert differ.mean() <= JAX_BF16_STORAGE_DIFFER, (name, differ.mean())

    Q, K, V, G = (x.double() for x in leaves)
    scale = 1.0 / math.sqrt(d)
    p = torch.softmax(Q @ K.transpose(-1, -2) * scale, dim=-1)
    delta = port_attn.flash_delta(out_p, leaves[3]).double()
    delta_64 = (leaves[3] * out_p).double().sum(-1)
    assert _bf16_ulps(delta, delta_64).max() <= 1.0
    ds = p * (G @ V.transpose(-1, -2) - delta[..., None])
    refs = (p @ V, ds @ K * scale, ds.transpose(-1, -2) @ Q * scale,
            p.transpose(-1, -2) @ G)
    for a, ref, name in zip((out_p, *grads_p), refs,
                            ("out", "dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        assert _bf16_ulps(a, ref).max() <= 1.0, (
            name, _bf16_ulps(a, ref).max().item())


# --- K1, K2 and K3 in (128, 256]: the split tensor-core kernels ------------


class _Library:
    """A stand-in for the built library: each entry point records its
    name and arguments and returns 0 (a launch that went through)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mmef_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers on CPU tensors with the device checks left out and the
    library replaced by ``_Library``."""
    lib = _Library()
    kernels = importlib.import_module(
        "multimodal_eeg_fmri_tpu_torch.ops._kernels")
    monkeypatch.setattr(kernels, "library", lambda: lib)
    check = port_attn._check_kernel_inputs

    def on_cpu(name, q, *rest):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
            return check(name, q, *rest)

    monkeypatch.setattr(port_attn, "_check_kernel_inputs", on_cpu)
    monkeypatch.setattr(port_attn, "_check_stats", lambda *a: None)
    monkeypatch.setattr(port_attn, "_stream", lambda t: 0)
    port_attn.reset_kernel_launches()
    yield lib
    port_attn.reset_kernel_launches()


# (true head dim, entry-point suffix and launch head dim): K1, K2 and K3
# share the split instances up to 256 and the deep tensor-core kernels past
# it, at d padded to a multiple of 64
SPLIT_ROUTES = [(129, "_split", 192), (160, "_split", 192),
                (192, "_split", 192), (256, "_split", 256)]
# (12,449 is past the old limit of 12,448)
FORWARD_ROUTES = SPLIT_ROUTES + [(d, "_deep", kd) for d, kd in
                                 sorted(DEEP_PADDED.items()) if d != 300] + [
    (12449, "_deep", 12480)]
BACKWARD_ROUTES = SPLIT_ROUTES + [(d, "_deep", kd) for d, kd in
                                  sorted(DEEP_PADDED.items())] + [
    (12449, "_deep", 12480)]


@pytest.mark.parametrize("d,suffix,kd", BACKWARD_ROUTES)
def test_backward_routes_by_head_dim(stand_in, d, suffix, kd):
    """K2 and K3 at d in (128, 256] launch the split tensor-core entry
    points at the padded head dim with the true scale 1/√d; past 256 the
    deep tensor-core ones at d padded to a multiple of 64, with the true
    scale. The counts record the entry point and launch head dim, and the
    outputs come back at d."""
    q, k, v, g = _inputs(d, torch.float32, tq=5, tk=7)
    lse = torch.zeros(2, 2, 5)
    dk, dv = port_attn.flash_bwd_dkv_cuda(q, k, v, g, lse, lse)
    dq = port_attn.flash_bwd_dq_cuda(q, k, v, g, lse, lse)
    assert dk.shape == dv.shape == k.shape and dq.shape == q.shape
    names = [name for name, _ in stand_in.calls]
    assert names == [f"mmef_flash_bwd_dkv{suffix}",
                     f"mmef_flash_bwd_dq{suffix}"]
    for name, args in stand_in.calls:
        # ... B, H, Tq, Tk, D, is_bf16, bf16_ops, scale, strides, stream
        B, H, tq, tk, launch_d, _, _, scale = args[-10:-2]
        assert (B, H, tq, tk, launch_d) == (2, 2, 5, 7, kd), name
        assert scale == pytest.approx(1.0 / math.sqrt(d), rel=1e-12)
        # q's strides: the padded (contiguous) input's at kd
        assert list(args[-2])[:3] == [2 * 5 * kd, 5 * kd, kd], name
    assert port_attn.kernel_launches_by_instance() == {
        "flash_fwd": {},
        "flash_bwd_dkv": {f"mmef_flash_bwd_dkv{suffix} D={kd}": 1},
        "flash_bwd_dq": {f"mmef_flash_bwd_dq{suffix} D={kd}": 1}}
    assert port_attn.kernel_launches_by_head_dim()["flash_bwd_dq"] == {d: 1}


@pytest.mark.parametrize("d,suffix,kd", FORWARD_ROUTES)
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_ops", "bf16_ops"])
def test_forward_routes_by_head_dim(stand_in, d, suffix, kd, storage,
                                    compute_dtype):
    """K1 at d in (128, 256] launches the split tensor-core entry point on
    q, k, v zero-padded to its instance, with the true scale 1/√d; past 256
    the deep one on q, k, v zero-padded to a multiple of 64, with the true
    scale. The operand mode reaches the kernel
    as its bf16_ops flag. The counts record the storage, the true head dim
    and the entry point at its launch head dim, and the outputs come back
    at d."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    q, k, v, _ = _inputs(d, dtype, tq=5, tk=7)
    out, lse = port_attn.flash_forward_cuda(q, k, v, compute_dtype)
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (2, 2, 5) and lse.dtype == torch.float32
    ((name, args),) = stand_in.calls
    assert name == f"mmef_flash_fwd{suffix}"
    # q, k, v, O, lse, B, H, Tq, Tk, D, is_bf16, bf16_ops, scale, strides,
    # stream
    assert args[5:12] == (2, 2, 5, 7, kd, int(storage == "bf16"),
                          int(compute_dtype == torch.bfloat16))
    assert args[12] == pytest.approx(1.0 / math.sqrt(d), rel=1e-12)
    # the strides the kernel reads are those of the padded (contiguous)
    # inputs at kd
    assert list(args[13])[:3] == [2 * 5 * kd, 5 * kd, kd]
    assert port_attn.kernel_launches_by_instance()["flash_fwd"] == {
        f"mmef_flash_fwd{suffix} D={kd}": 1}
    assert port_attn.kernel_launches_by_head_dim()["flash_fwd"] == {d: 1}
    assert port_attn.kernel_launches()["flash_fwd"] == {
        "f32": int(storage == "f32"), "bf16": int(storage == "bf16")}


def test_grid_rows_past_256(stand_in):
    """Past 256 the deep K1 takes 64 rows a block on the grid's y axis, K2
    and K3 32, and the wrappers hold all three to the smaller: 70,000 rows
    launch, 65,535 × 32 + 1 are refused. Zero-stride views: no input of
    70,000 rows is made."""
    q = torch.zeros(1, 1, 1, 320).expand(1, 1, 70000, 320)
    lse = torch.zeros(1, 1, 70000)
    out, lse_k = port_attn.flash_forward_cuda(q, q, q)
    dk, dv = port_attn.flash_bwd_dkv_cuda(q, q, q, q, lse, lse)
    dq = port_attn.flash_bwd_dq_cuda(q, q, q, q, lse, lse)
    assert out.shape == dk.shape == dv.shape == dq.shape == q.shape
    assert lse_k.shape == lse.shape
    assert [name for name, _ in stand_in.calls] == [
        "mmef_flash_fwd_deep", "mmef_flash_bwd_dkv_deep",
        "mmef_flash_bwd_dq_deep"]
    too_many = torch.zeros(1, 1, 1, 320).expand(1, 1, 65535 * 32 + 1, 320)
    with pytest.raises(ValueError, match="unsupported sizes"):
        port_attn.flash_forward_cuda(too_many, q, q)


def test_backward_past_the_limit_raises(stand_in):
    """K1, K2 and K3 refuse a head dim past the grid's bound with
    ``unsupported sizes`` before they launch (the inputs are broadcast
    views, so nothing that wide is allocated)."""
    d = port_attn.WIDE_MAX_HEAD_DIM + 1
    q = torch.zeros(1, 1, 1, 1).expand(1, 1, 2, d)
    lse = torch.zeros(1, 1, 2)
    with pytest.raises(ValueError, match="unsupported sizes"):
        port_attn.flash_forward_cuda(q, q, q)
    for fn in (port_attn.flash_bwd_dkv_cuda, port_attn.flash_bwd_dq_cuda):
        with pytest.raises(ValueError, match="unsupported sizes"):
            fn(q, q, q, q, lse, lse)
    assert not stand_in.calls


def test_long_context_d256_matches_jax(monkeypatch):
    """One train step of ``LongContextClassifier(hidden_dim=512,
    num_heads=2)``, head dim 256, one layer, on the flash route at T=40:
    the port (K1-K3's plain versions on the CPU, the functions the split
    kernels compute) against the JAX package (its Pallas kernel
    in interpret mode, which pads D to 256 lanes), from the same seeded
    flax variables through ``load_flax_variables``. The weighted CE within
    1e-5; every weight and input gradient within 1e-4 of the largest
    (``test_torch_port_long_context.py``'s gates); the port's one forward
    and one backward, and JAX's flash call, at D=256."""
    from test_torch_port_long_context import (
        _pair,
        _weighted_ce_j,
        _weighted_ce_t,
    )
    from test_torch_port_moe import _grads_close

    from multimodal_eeg_fmri_tpu_torch import load_flax_variables
    from multimodal_eeg_fmri_tpu_torch.models import long_context as t_lc

    calls = {"jax": [], "port_fwd": [], "port_bwd": []}
    jax_flash = jax_attn.flash_attention
    port_fwd, port_bwd = port_attn._flash_forward, port_attn._flash_backward

    def jax_interpret(q, *a, **kw):
        calls["jax"].append(q.shape[-1])
        return jax_flash(q, *a, interpret=True, **kw)

    monkeypatch.setattr(jax_attn, "flash_attention", jax_interpret)
    monkeypatch.setattr(port_attn, "_flash_forward", lambda q, *a: (
        calls["port_fwd"].append(q.shape[-1]), port_fwd(q, *a))[1])
    monkeypatch.setattr(port_attn, "_flash_backward", lambda q, *a: (
        calls["port_bwd"].append(q.shape[-1]), port_bwd(q, *a))[1])
    kw = dict(hidden_dim=512, num_layers=1, num_heads=2, attn_impl="flash")
    B = 2
    fmod, tmod, variables, inputs = _pair(kw, 40, B=B)

    def loss_j(params, erp):
        o = fmod.apply({"params": params}, erp=erp, train=True)
        return _weighted_ce_j(o.logits, B)

    loss_w, (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        variables["params"], jnp.asarray(inputs["erp"]))
    erp = torch.from_numpy(inputs["erp"]).requires_grad_()
    loss_t = _weighted_ce_t(tmod.train()(erp=erp).logits, B)
    loss_t.backward()
    # JAX traces its flash call more than once; the port runs it once
    assert set(calls.pop("jax")) == {256}
    assert calls == {"port_fwd": [256], "port_bwd": [256]}
    np.testing.assert_allclose(loss_t.item(), float(loss_w), atol=1e-5,
                               rtol=0)
    want = load_flax_variables(
        t_lc.LongContextClassifier(**kw, device="cpu"),
        jax.tree.map(np.asarray, gp)).state_dict()
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    _grads_close({**got, "erp": erp.grad.numpy()},
                 {**{k: want[k].numpy() for k in got}, "erp": gx})
