"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``multimodal_eeg_fmri_tpu/ops/attention.py``.
``flash_attention`` and ``flash_attention_lse`` are differentiable. On a CUDA
tensor the forward launches K1 (``csrc/flash_fwd.cu``) and the backward K2
and K3 (``csrc/flash_bwd.cu``), all built by ``ops/_kernels.py``, or raise;
on a CPU tensor they run the plain PyTorch math of the same kernels, so the
CPU tests check the formulas the kernels implement. Each kernel wrapper
counts its launches in a plain int attribute, ``launches``;
``kernel_launches()`` reads the three counts.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

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


def flash_delta(o, g, g_lse=None) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) − g_lse in f32, (B, H, Tq). Folding the lse
    cotangent into Δ is all that ``flash_attention_lse``'s backward adds:
    ∂lse_r/∂s_rc = p_rc, so it contributes + p ⊙ g_lse to dS."""
    delta = (g.float() * o.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _recompute_plain(q, k, v, g, lse, delta, compute_dtype):
    """What both backward kernels recompute: S·scale after the dot,
    P = exp(S − lse) and dS = P ⊙ (dO·Vᵀ − Δ). Returns (operand cast, q, k,
    dO as product operands, P, dS, scale). bf16 mode rounds q, k, v and dO,
    and P and dS before their products, to bf16; every sum stays f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def op(x):  # a product operand in compute_dtype, summed in f32
        return x.to(compute_dtype).float()

    qc, kc, gc = op(q), op(k), op(g)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
    # a row with lse = +inf (no key) gets p = 0
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gc, op(v))
    ds = p * (dp - delta.float()[..., None])
    return op, qc, kc, gc, p, ds, scale


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, compute_dtype=torch.float32):
    """K2's math in plain PyTorch: (dk, dv) with dV = Pᵀ·dO and
    dK = dSᵀ·Q·scale; arguments as ``flash_bwd_dkv_cuda``."""
    op, qc, _, gc, p, ds, scale = _recompute_plain(q, k, v, g, lse, delta,
                                                   compute_dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", op(p), gc)
    dk = torch.einsum("bhqk,bhqd->bhkd", op(ds), qc) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, g, lse, delta, compute_dtype=torch.float32):
    """K3's math in plain PyTorch: dQ = dS·K·scale; arguments as
    ``flash_bwd_dq_cuda``."""
    op, _, kc, _, _, ds, scale = _recompute_plain(q, k, v, g, lse, delta,
                                                  compute_dtype)
    dq = torch.einsum("bhqk,bhkd->bhqd", op(ds), kc) * scale
    return dq.to(q.dtype)


def flash_backward_plain(q, k, v, o, lse, g, g_lse=None,
                         compute_dtype=torch.float32):
    """The Δ glue and the two backward kernels' math in plain PyTorch:
    returns (dq, dk, dv) in the dtypes of q, k, v."""
    delta = flash_delta(o, g, g_lse)
    dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, compute_dtype)
    return flash_bwd_dq_plain(q, k, v, g, lse, delta, compute_dtype), dk, dv


def _check_kernel_inputs(name, q, k, v, compute_dtype, *extra):
    """The checks every kernel wrapper makes; ``extra`` are further
    (B,H,Tq,D) tensors of q's device, dtype and layout. Returns
    (B, H, Tq, Tk, D)."""
    tensors = (q, k, v, *extra)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash kernels take f32 or bf16 tensors of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,Tq,D), k = v (B,H,Tk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D or any(
            t.shape != q.shape for t in extra):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"{[tuple(t.shape) for t in extra]} disagree")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    if min(B, H, Tq, Tk) < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B={B} H={H} Tq={Tq} Tk={Tk}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the head dim of every kernel input must be "
                         "contiguous")
    return B, H, Tq, Tk, D


def _strides(*tensors):
    """(batch, head, time) element strides of each tensor, for the C side."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_cuda(q, k, v, compute_dtype=torch.float32):
    """Launch K1: (out (B,H,Tq,D) in q.dtype, lse (B,H,Tq) f32). Raises on
    anything the kernel does not take; does not synchronise."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_forward_cuda", q, k, v,
                                           compute_dtype)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = library().mmef_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, D, int(q.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), _strides(q, k, v), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_forward_cuda.launches += 1
    return out, lse


def _check_stats(lse, delta, B, H, Tq, device):
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, Tq)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 (B,H,Tq) on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, compute_dtype=torch.float32):
    """Launch K2: (dk, dv) (B,H,Tk,D) in k's dtype, from dO = ``g`` and the
    f32 (B,H,Tq) ``lse`` and ``delta`` (``flash_delta``)."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_bwd_dkv_cuda", q, k, v,
                                           compute_dtype, g)
    _check_stats(lse, delta, B, H, Tq, q.device)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, H, Tk, D), dtype=v.dtype, device=v.device)
    err = library().mmef_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Tq, Tk, D, int(q.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), _strides(q, k, v, g),
        _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: "
                           f"cudaError {err}")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, compute_dtype=torch.float32):
    """Launch K3: dq (B,H,Tq,D) in q's dtype; arguments as
    ``flash_bwd_dkv_cuda``."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_bwd_dq_cuda", q, k, v,
                                           compute_dtype, g)
    _check_stats(lse, delta, B, H, Tq, q.device)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    err = library().mmef_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq, Tk, D,
        int(q.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
        _strides(q, k, v, g), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: "
                           f"cudaError {err}")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_forward_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0


def kernel_launches() -> dict:
    """Launches of each flash kernel since the counts were last reset."""
    return {"flash_fwd": flash_forward_cuda.launches,
            "flash_bwd_dkv": flash_bwd_dkv_cuda.launches,
            "flash_bwd_dq": flash_bwd_dq_cuda.launches}


def reset_kernel_launches() -> None:
    flash_forward_cuda.launches = 0
    flash_bwd_dkv_cuda.launches = 0
    flash_bwd_dq_cuda.launches = 0


def flash_backward_cuda(q, k, v, o, lse, g, g_lse=None,
                        compute_dtype=torch.float32):
    """Launch K2 and K3 after the Δ glue: (dq, dk, dv). Raises on anything
    the kernels do not take; does not synchronise."""
    _check_kernel_inputs("flash_backward_cuda", q, k, v, compute_dtype, g, o)
    delta = flash_delta(o, g, g_lse).contiguous()
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, compute_dtype)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, compute_dtype)
    return dq, dk, dv


def _flash_forward(q, k, v, compute_dtype):
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, compute_dtype)
    return flash_forward_cuda(q, k, v, compute_dtype)


def _flash_backward(q, k, v, o, lse, g, g_lse, compute_dtype):
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, g, g_lse, compute_dtype)
    return flash_backward_cuda(q, k, v, o, lse, g, g_lse, compute_dtype)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the residuals (q, k, v, o, lse) saved for
    the two backward kernels; differentiable in both outputs, and the
    cotangent of lse folds into Δ."""

    @staticmethod
    def forward(ctx, q, k, v, compute_dtype):
        out, lse = _flash_forward(q, k, v, compute_dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.compute_dtype = compute_dtype
        # an output that is not used gets None, not a tensor of zeros
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(o)
        elif g.stride(-1) != 1:
            # autograd may hand over an expanded cotangent; the kernels read
            # dO with its last dim contiguous
            g = g.contiguous()
        dq, dk, dv = _flash_backward(q, k, v, o, lse, g, g_lse,
                                     ctx.compute_dtype)
        return dq, dk, dv, None


def flash_attention(q, k, v, compute_dtype=torch.float32) -> torch.Tensor:
    """Non-causal blockwise attention, q (B,H,Tq,D), k/v (B,H,Tk,D);
    differentiable in q, k and v.

    ``compute_dtype=torch.bfloat16`` feeds the per-tile products bf16
    operands, with f32 sums and f32 softmax statistics."""
    return _FlashAttention.apply(q, k, v, compute_dtype)[0]


def flash_attention_lse(q, k, v, compute_dtype=torch.float32):
    """``flash_attention`` that also returns the per-row logsumexp
    (B, H, Tq) in f32; differentiable in both outputs."""
    return _FlashAttention.apply(q, k, v, compute_dtype)


def attention(q, k, v, min_flash_len: int = 256,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Einsum path for short sequences, flash once either length reaches
    ``min_flash_len``."""
    if q.shape[2] < min_flash_len and k.shape[2] < min_flash_len:
        return reference_attention(q, k, v)
    return flash_attention(q, k, v, compute_dtype=compute_dtype)
