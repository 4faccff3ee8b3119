"""The hand-written flash-attention kernel against its plain version.

These tests run the CUDA kernel, which has no CPU mode: they are marked
``cuda`` and skip where there is no GPU. They import no JAX, so on a machine
with a card and without JAX they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel.py

Tolerances: f32 out and lse within 2e-5 (sums taken in another order); the
bf16-operand mode within 1e-2, since the kernel rounds p to bf16 against a
running max tile by tile where the plain version uses the row's final max.
"""

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu_torch.ops import _kernels
from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    flash_attention,
    flash_forward_cuda,
    flash_forward_plain,
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
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    ref, _ = flash_forward_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["grad", "head_dim", "dtype", "last_stride"])
def test_kernel_wrapper_refuses(cuda_device, bad):
    q, k, v = _qkv(cuda_device, 1, 1, 8, 8, 32)
    err = {"grad": NotImplementedError, "dtype": TypeError}.get(bad, ValueError)
    if bad == "grad":
        q.requires_grad_(True)
    elif bad == "head_dim":
        q, k, v = _qkv(cuda_device, 1, 1, 8, 8, 48)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = torch.randn(1, 1, 32, 8, device=cuda_device).transpose(2, 3)
    with pytest.raises(err):
        flash_attention(q, k, v)
