"""The hand-written flash-attention kernels against their plain versions.

These tests run the CUDA kernels (K1 forward, K2 dK/dV, K3 dQ), which have
no CPU mode: they are marked ``cuda`` and skip where there is no GPU. They
import no JAX, so on a machine with a card and without JAX they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel.py

Tolerances: f32 out and lse within 2e-5 (sums taken in another order); the
forward's bf16-operand mode within 1e-2, since the kernel rounds p to bf16
against a running max tile by tile where the plain version uses the row's
final max. Gradients: f32 within 2e-4 (longer sums of larger terms); the
bf16-operand mode within 5e-2, the JAX package's own gradient tolerance for
that mode (``tests/test_attention.py``).
"""

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu_torch.ops import _kernels
from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_lse,
    flash_backward_cuda,
    flash_backward_plain,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
    flash_forward_cuda,
    flash_forward_plain,
    reference_attention,
)

CASES = [  # (B, H, Tq, Tk, D)
    (2, 2, 200, 333, 16),
    (1, 2, 130, 70, 32),
    (1, 3, 96, 160, 64),
    (8, 4, 256, 256, 32),
    (8, 4, 512, 512, 32),
    (2, 2, 300, 333, 128),
    (1, 1, 1, 1, 32),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, B, H, tq, tk, d, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(
        device) for s in ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d)))


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    """A changed source gets a new library name, so it is built anew."""
    src = tmp_path / "flash_fwd.cu"
    src.write_bytes((_kernels.CSRC / "flash_fwd.cu").read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    name = _kernels.library_path().name
    assert name.startswith("libmmef_kernels_") and name.endswith(".so")
    assert _kernels.library_path().name == name
    src.write_text(src.read_text() + "\n// changed\n")
    assert _kernels.library_path().name != name


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.find_nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compute_dtype,atol",
                         [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(cuda_device, case, compute_dtype, atol):
    q, k, v = _qkv(cuda_device, *case)
    out_k, lse_k = flash_forward_cuda(q, k, v, compute_dtype)
    out_p, lse_p = flash_forward_plain(q, k, v, compute_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=atol, rtol=0)
    torch.testing.assert_close(lse_k, lse_p, atol=atol, rtol=0)


@pytest.mark.cuda
def test_kernel_takes_bf16_storage(cuda_device):
    q, k, v = (t.bfloat16() for t in _qkv(cuda_device, 2, 2, 130, 200, 64))
    out_k, lse_k = flash_forward_cuda(q, k, v)
    out_p, lse_p = flash_forward_plain(q, k, v)
    torch.cuda.synchronize()
    assert out_k.dtype == torch.bfloat16
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse_k, lse_p, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs_and_counts(cuda_device):
    B, T, H, D = 2, 300, 4, 32
    x = torch.randn(3, B, T, H, D, device=cuda_device)
    q, k, v = (t.transpose(1, 2) for t in x)  # (B, H, T, D), not contiguous
    before = flash_forward_cuda.launches
    out = flash_attention(q, k, v)
    assert flash_forward_cuda.launches == before + 1
    ref, _ = flash_forward_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["mixed_dtype", "head_dim", "dtype",
                                 "last_stride"])
def test_kernel_wrapper_refuses(cuda_device, bad):
    q, k, v = _qkv(cuda_device, 1, 1, 8, 8, 32)
    err = {"mixed_dtype": TypeError, "dtype": TypeError}.get(bad, ValueError)
    if bad == "mixed_dtype":
        q = q.bfloat16()
    elif bad == "head_dim":
        q, k, v = _qkv(cuda_device, 1, 1, 8, 8, 48)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = torch.randn(1, 1, 32, 8, device=cuda_device).transpose(2, 3)
    with pytest.raises(err):
        flash_attention(q, k, v)


def _backward_inputs(device, case, compute_dtype, seed=1):
    q, k, v = _qkv(device, *case, seed=seed)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape, dtype=np.float32)).to(device)
    out, lse = flash_forward_plain(q, k, v, compute_dtype)
    return q, k, v, out, lse, g


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compute_dtype,atol",
                         [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)])
def test_backward_kernels_match_plain(cuda_device, case, compute_dtype, atol):
    q, k, v, out, lse, g = _backward_inputs(cuda_device, case, compute_dtype)
    g_lse = torch.randn(lse.shape, device=cuda_device)
    before = (flash_bwd_dkv_cuda.launches, flash_bwd_dq_cuda.launches)
    got = flash_backward_cuda(q, k, v, out, lse, g, g_lse, compute_dtype)
    want = flash_backward_plain(q, k, v, out, lse, g, g_lse, compute_dtype)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv_cuda.launches, flash_bwd_dq_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=name)


@pytest.mark.cuda
def test_backward_kernels_take_bf16_storage(cuda_device):
    q, k, v, out, lse, g = (t.bfloat16() if t.dim() == 4 else t
                            for t in _backward_inputs(
                                cuda_device, (2, 2, 130, 200, 64),
                                torch.float32))
    got = flash_backward_cuda(q, k, v, out, lse, g)
    want = flash_backward_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
def test_autograd_through_kernels_matches_reference(cuda_device, with_lse):
    """Gradients of flash_attention(_lse) on the card (K1 + K2 + K3) against
    autograd through the einsum reference, with strided (B,T,H,D) inputs."""
    B, T, H, D = 2, 300, 4, 32
    x = torch.randn(3, B, T, H, D, device=cuda_device, requires_grad=True)
    q, k, v = (t.transpose(1, 2) for t in x)
    g = torch.randn(B, H, T, D, device=cuda_device)
    g_lse = torch.randn(B, H, T, device=cuda_device)
    scale = 1.0 / np.sqrt(D)
    if with_lse:
        out, lse = flash_attention_lse(q, k, v)
        loss = (out * g).sum() + (lse * g_lse).sum()
        ref_lse = torch.logsumexp(
            torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, dim=-1)
        ref = (reference_attention(q, k, v) * g).sum() + (ref_lse * g_lse).sum()
    else:
        loss = (flash_attention(q, k, v) * g).sum()
        ref = (reference_attention(q, k, v) * g).sum()
    before = (flash_bwd_dkv_cuda.launches, flash_bwd_dq_cuda.launches)
    (got,) = torch.autograd.grad(loss, x)
    (want,) = torch.autograd.grad(ref, x)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv_cuda.launches, flash_bwd_dq_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_backward_wrapper_refuses(cuda_device):
    q, k, v, out, lse, g = _backward_inputs(cuda_device, (1, 1, 8, 8, 32),
                                            torch.float32)
    with pytest.raises(ValueError, match="lse"):
        flash_backward_cuda(q, k, v, out, lse[..., :4], g)
    with pytest.raises(ValueError):
        flash_backward_cuda(q, k, v, out, lse, g[..., :4, :])
    with pytest.raises(ValueError, match="CUDA"):
        flash_backward_cuda(q, k.cpu(), v, out, lse, g)
