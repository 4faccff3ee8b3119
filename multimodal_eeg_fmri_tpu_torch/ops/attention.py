"""Flash attention: the hand-written CUDA forward and its plain version.

Counterpart of ``multimodal_eeg_fmri_tpu/ops/attention.py``. On a CUDA
tensor ``flash_attention`` and ``flash_attention_lse`` launch the kernel in
``csrc/flash_fwd.cu`` (built by ``ops/_kernels.py``) or raise; on a CPU
tensor they run the plain PyTorch math of the same function. Each counts its
kernel launches in a plain int attribute, ``launches``.

The forward has no gradient on CUDA yet: the backward kernels are ROADMAP
queue B items 2-5, and until they land an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_NO_BACKWARD = ("the CUDA flash-attention forward has no backward yet "
                "(ROADMAP.md, queue B items 2-5: the dK/dV and dQ kernels and "
                "the autograd.Function); call it under torch.no_grad() or "
                "torch.inference_mode(), or use attn_impl='einsum'")
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(q, k, v, scale: Optional[float] = None,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain einsum attention (the oracle and the short-sequence path).
    q: (B, H, Tq, D), k/v: (B, H, Tk, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def flash_forward_plain(q, k, v, compute_dtype=torch.float32):
    """The kernel's math in plain PyTorch: returns (out (B,H,Tq,D) in
    q.dtype, lse (B,H,Tq) f32). f32 mode scales q before the dot; bf16 mode
    rounds the q/k and p/v operands to bf16 and scales after the dot."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if compute_dtype == torch.float32:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(compute_dtype).float(),
                         k.to(compute_dtype).float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(compute_dtype).float(),
                       v.to(compute_dtype).float())
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse


def flash_forward_cuda(q, k, v, compute_dtype=torch.float32):
    """Launch the CUDA kernel: (out (B,H,Tq,D) in q.dtype, lse (B,H,Tq) f32).
    Raises on anything the kernel does not take; does not synchronise."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_forward_cuda needs q, k, v on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,Tq,D), k = v (B,H,Tk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    if min(B, H, Tq, Tk) < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B={B} H={H} Tq={Tq} Tk={Tk}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(_NO_BACKWARD)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    lib = library()
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    err = lib.mmef_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, D, int(q.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    return out, lse


def _flash_forward(q, k, v, compute_dtype):
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, compute_dtype), False
    return flash_forward_cuda(q, k, v, compute_dtype), True


def flash_attention(q, k, v, compute_dtype=torch.float32) -> torch.Tensor:
    """Non-causal blockwise attention, q (B,H,Tq,D), k/v (B,H,Tk,D).

    ``compute_dtype=torch.bfloat16`` feeds the per-tile products bf16
    operands, with f32 sums and f32 softmax statistics."""
    (out, _), launched = _flash_forward(q, k, v, compute_dtype)
    flash_attention.launches += launched
    return out


def flash_attention_lse(q, k, v, compute_dtype=torch.float32):
    """``flash_attention`` that also returns the per-row logsumexp
    (B, H, Tq) in f32."""
    (out, lse), launched = _flash_forward(q, k, v, compute_dtype)
    flash_attention_lse.launches += launched
    return out, lse


flash_attention.launches = 0
flash_attention_lse.launches = 0


def attention(q, k, v, min_flash_len: int = 256,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Einsum path for short sequences, flash once either length reaches
    ``min_flash_len``."""
    if q.shape[2] < min_flash_len and k.shape[2] < min_flash_len:
        return reference_attention(q, k, v)
    return flash_attention(q, k, v, compute_dtype=compute_dtype)
