"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``multimodal_eeg_fmri_tpu/ops/attention.py``.
``flash_attention`` and ``flash_attention_lse`` are differentiable. On a CUDA
tensor the forward launches K1 (``csrc/flash_fwd.cu``) and the backward K2
and K3 (``csrc/flash_bwd.cu``), all built by ``ops/_kernels.py``, or raise;
on a CPU tensor they run the plain PyTorch math of the same kernels, so the
CPU tests check the formulas the kernels implement. Each kernel wrapper
counts its launches by storage dtype in a dict attribute, ``launches``
({"f32": n, "bf16": m}), by true head dim in ``launches_by_head_dim``, and
by the C entry point and launch head dim that ran in
``launches_by_instance``; ``kernel_launches()``,
``kernel_launches_by_head_dim()`` and ``kernel_launches_by_instance()``
read the three kernels' counts. The forward is reached through the
operator ``mmef::flash_fwd``, which ``torch.func.vmap`` folds into one
launch and ``torch.export`` traces, and the backward through
``mmef::flash_bwd``, which vmap folds the same way.

The tensor-core kernels are built for the head dims in
``KERNEL_HEAD_DIMS``. A wrapper given another head dim d ≤ 128 zero-pads q,
k, v (and dO) to the next one, passes the kernel the true scale 1/√d and
slices its outputs back to d, as the JAX package's wrapper pads to 128
lanes: the zero columns add nothing to Q·Kᵀ, give zero output and gradient
columns, and leave Δ = rowsum(dO∘O) as it is. The padding stays inside the
``*_cuda`` wrappers, so the operators and everything above them see the
true d. Past 128, K1, K2 and K3 pad d ≤ 256 the same way to the instances
in ``SPLIT_HEAD_DIMS``, tensor-core kernels that split the D-wide sums over
their warps (``csrc/flash_fwd_split.cu``, ``csrc/flash_bwd_split.cu``).
Past 256 (up to ``WIDE_MAX_HEAD_DIM``, the grid's bound) all three pad d
to a multiple of ``DEEP_CHUNK`` for tensor-core kernels that sum the scores
over column chunks and split the D-wide outputs into column slices
(``csrc/flash_fwd_deep.cu``, ``csrc/flash_bwd_deep.cu``). All count as the
launches of K1, K2 and K3. ``mmef::flash_fwd`` carries its own gradient
(``torch.library.register_autograd``), so a program that ``torch.export``
traced and ``core/aot.py`` loaded reaches K2 and K3 in its backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch._C import _functorch

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# K1-K3 on the tensor cores past 128, the D-wide sums split over warps
SPLIT_HEAD_DIMS = (192, 256)
# K1, K2 and K3 past 256 take any multiple of this (their column chunk),
# the head dim zero-padded to one
DEEP_CHUNK = 64
# the largest head dim the wrappers take. No kernel keeps a row of width D:
# past 256 they stage 64-column chunks and give each block on the grid's z
# axis a slice of 512 output columns, so only gridDim.z (65,535 slices)
# bounds them
WIDE_MAX_HEAD_DIM = 65535 * 512


def kernel_head_dim(d: int) -> int:
    """The head dim of the tensor-core instance that computes head dim
    ``d``: the smallest of ``KERNEL_HEAD_DIMS`` not below it."""
    for kd in KERNEL_HEAD_DIMS:
        if 1 <= d <= kd:
            return kd
    raise ValueError(f"head dim {d} is outside the tensor-core instances' "
                     f"range 1..{KERNEL_HEAD_DIMS[-1]}")


def _launch(name: str, d: int) -> Tuple[str, int]:
    """(C entry point, launch head dim) of kernel ``name`` (its C entry
    point's name) at true head dim d: the tensor-core instance for d ≤ 128
    and, past it, up to 256 (``_split``); past that, the tensor-core kernel
    at d padded to a multiple of ``DEEP_CHUNK`` (``_deep``)."""
    if d > WIDE_MAX_HEAD_DIM:
        raise ValueError(f"unsupported sizes: head dim {d} is past the grid's "
                         f"limit of 65,535 column slices of 512 "
                         f"({WIDE_MAX_HEAD_DIM})")
    if d <= KERNEL_HEAD_DIMS[-1]:
        return name, kernel_head_dim(d)
    if d <= SPLIT_HEAD_DIMS[-1]:
        return f"{name}_split", next(kd for kd in SPLIT_HEAD_DIMS if d <= kd)
    return f"{name}_deep", -(-d // DEEP_CHUNK) * DEEP_CHUNK


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` zero-padded on its last axis to ``d`` (``x`` itself when it
    is that wide already)."""
    if x.shape[-1] == d:
        return x
    return torch.nn.functional.pad(x, (0, d - x.shape[-1]))


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


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_forward_plain(q, k, v, compute_dtype=torch.float32, scale=None):
    """The kernel's math in plain PyTorch: returns (out (B,H,Tq,D) in
    q.dtype, lse (B,H,Tq) f32). f32 mode scales q before the dot; bf16 mode
    rounds the q/k and p/v operands to bf16 and scales after the dot.
    ``scale`` defaults to 1/√D."""
    scale = _scale(q, scale)
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
    """Δ = rowsum(dO ⊙ O) − g_lse as f32, (B, H, Tq). The product and the
    row sum are in the storage dtype, as the JAX package's ``jnp.sum`` of
    dO ⊙ O (bf16 storage rounds both, the sum accumulated in f32). Folding
    the lse cotangent into Δ is all that ``flash_attention_lse``'s backward
    adds: ∂lse_r/∂s_rc = p_rc, so it contributes + p ⊙ g_lse to dS."""
    delta = (g * o).sum(dim=-1).float()
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _recompute_plain(q, k, v, g, lse, delta, compute_dtype, scale):
    """What both backward kernels recompute: S·scale after the dot,
    P = exp(S − lse) and dS = P ⊙ (dO·Vᵀ − Δ). Returns (operand cast, q, k,
    dO as product operands, P, dS, scale). bf16 mode rounds q, k, v and dO,
    and P and dS before their products, to bf16; every sum stays f32."""
    scale = _scale(q, scale)

    def op(x):  # a product operand in compute_dtype, summed in f32
        return x.to(compute_dtype).float()

    qc, kc, gc = op(q), op(k), op(g)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
    # a row with lse = +inf (no key) gets p = 0
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gc, op(v))
    ds = p * (dp - delta.float()[..., None])
    return op, qc, kc, gc, p, ds, scale


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, compute_dtype=torch.float32,
                        scale=None):
    """K2's math in plain PyTorch: (dk, dv) with dV = Pᵀ·dO and
    dK = dSᵀ·Q·scale; arguments as ``flash_bwd_dkv_cuda``, ``scale`` as
    ``flash_forward_plain``'s."""
    op, qc, _, gc, p, ds, scale = _recompute_plain(q, k, v, g, lse, delta,
                                                   compute_dtype, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", op(p), gc)
    dk = torch.einsum("bhqk,bhqd->bhkd", op(ds), qc) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, g, lse, delta, compute_dtype=torch.float32,
                       scale=None):
    """K3's math in plain PyTorch: dQ = dS·K·scale; arguments as
    ``flash_bwd_dq_cuda``, ``scale`` as ``flash_forward_plain``'s."""
    op, _, kc, _, _, ds, scale = _recompute_plain(q, k, v, g, lse, delta,
                                                  compute_dtype, scale)
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
    _launch("mmef_flash_fwd", D)
    # B·H runs on the grid's x axis (2^31 − 1 blocks), the row tiles of Tq
    # (K1, K3) or Tk (K2) on its y axis (65,535): 64 rows a block up to head
    # dim 128; past it 64 in K1 and 32 in K2 and K3, the smaller taken for
    # all three (past 256 their column slices run on the z axis)
    rows_per_block = 64 if D <= KERNEL_HEAD_DIMS[-1] else 32
    if (min(B, H, Tq, Tk) < 1 or B * H > 2**31 - 1
            or max(Tq, Tk) > 65535 * rows_per_block):
        raise ValueError(f"unsupported sizes B={B} H={H} Tq={Tq} Tk={Tk}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the head dim of every kernel input must be "
                         "contiguous")
    return B, H, Tq, Tk, D


def _strides(*tensors):
    """(batch, head, time) element strides of each tensor, for the C side."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _storage(t) -> str:
    """The launch counts' key: the storage dtype of a kernel's inputs."""
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _count(fn, q, d: int, entry: str, kd: int) -> None:
    """One launch of ``fn``'s kernel on ``q``'s storage at head dim d,
    through C entry point ``entry`` at launch head dim ``kd``."""
    fn.launches[_storage(q)] += 1
    fn.launches_by_head_dim[d] = fn.launches_by_head_dim.get(d, 0) + 1
    key = f"{entry} D={kd}"
    fn.launches_by_instance[key] = fn.launches_by_instance.get(key, 0) + 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_cuda(q, k, v, compute_dtype=torch.float32):
    """Launch K1: (out (B,H,Tq,D) in q.dtype, lse (B,H,Tq) f32). Raises on
    anything the kernel does not take; does not synchronise."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_forward_cuda", q, k, v,
                                           compute_dtype)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    entry, kd = _launch("mmef_flash_fwd", D)
    q, k, v = (pad_head_dim(t, kd) for t in (q, k, v))
    out = torch.empty((B, H, Tq, kd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, kd, int(q.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), 1.0 / math.sqrt(D),
        _strides(q, k, v), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    _count(flash_forward_cuda, q, D, entry, kd)
    return out[..., :D], lse


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

    entry, kd = _launch("mmef_flash_bwd_dkv", D)
    q, k, v, g = (pad_head_dim(t, kd) for t in (q, k, v, g))
    dk = torch.empty((B, H, Tk, kd), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, H, Tk, kd), dtype=v.dtype, device=v.device)
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Tq, Tk, kd, int(q.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), 1.0 / math.sqrt(D),
        _strides(q, k, v, g), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: "
                           f"cudaError {err}")
    _count(flash_bwd_dkv_cuda, q, D, entry, kd)
    return dk[..., :D], dv[..., :D]


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, compute_dtype=torch.float32):
    """Launch K3: dq (B,H,Tq,D) in q's dtype; arguments as
    ``flash_bwd_dkv_cuda``."""
    B, H, Tq, Tk, D = _check_kernel_inputs("flash_bwd_dq_cuda", q, k, v,
                                           compute_dtype, g)
    _check_stats(lse, delta, B, H, Tq, q.device)
    from multimodal_eeg_fmri_tpu_torch.ops._kernels import library

    entry, kd = _launch("mmef_flash_bwd_dq", D)
    q, k, v, g = (pad_head_dim(t, kd) for t in (q, k, v, g))
    dq = torch.empty((B, H, Tq, kd), dtype=q.dtype, device=q.device)
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq, Tk, kd,
        int(q.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
        1.0 / math.sqrt(D), _strides(q, k, v, g), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: "
                           f"cudaError {err}")
    _count(flash_bwd_dq_cuda, q, D, entry, kd)
    return dq[..., :D]


_KERNELS = {"flash_fwd": flash_forward_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda}


def kernel_launches() -> dict:
    """Launches of each flash kernel since the counts were last reset, by
    storage dtype: {kernel: {"f32": n, "bf16": m}}."""
    return {k: dict(fn.launches) for k, fn in _KERNELS.items()}


def kernel_launches_by_head_dim() -> dict:
    """Launches of each flash kernel since the counts were last reset, by
    the true head dim: {kernel: {d: n}}."""
    return {k: dict(sorted(fn.launches_by_head_dim.items()))
            for k, fn in _KERNELS.items()}


def kernel_launches_by_instance() -> dict:
    """Launches of each flash kernel since the counts were last reset, by
    the C entry point that ran and its launch head dim:
    {kernel: {"<entry> D=<kd>": n}}."""
    return {k: dict(sorted(fn.launches_by_instance.items()))
            for k, fn in _KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in _KERNELS.values():
        fn.launches = {"f32": 0, "bf16": 0}
        fn.launches_by_head_dim = {}
        fn.launches_by_instance = {}


reset_kernel_launches()


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


def _compute_dtype(bf16_operands: bool) -> torch.dtype:
    return torch.bfloat16 if bf16_operands else torch.float32


def _bf16_operands(compute_dtype) -> bool:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


# K1 as a PyTorch operator, so that torch.func.vmap and torch.export reach
# it: ``mmef::flash_fwd`` runs the kernel on a CUDA tensor (or raises) and
# the plain version on a CPU tensor; its fake gives the output shapes; its
# vmap rule folds the vmapped axis into B for one launch. Its gradient (its
# own, and ``_FlashAttention``'s, the same formula) goes through
# ``mmef::flash_bwd`` (K2 and K3), whose vmap rule folds alike. Registering
# builds nothing: the library is built at the first CUDA call
# (``ops/_kernels.py``).
@torch.library.custom_op("mmef::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bf16_operands: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    out, lse = _flash_forward(q, k, v, _compute_dtype(bf16_operands))
    return out.contiguous(), lse.contiguous()


@flash_fwd_op.register_fake
def _(q, k, v, bf16_operands):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _fold(x, dim, n):
    """``x`` with its vmapped axis ``dim`` (None: not vmapped, so repeated
    ``n`` times) folded into the batch axis: (n·B, ...)."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    x = x.reshape(n * x.shape[1], *x.shape[2:])
    # a fold that copies keeps the head dim contiguous; a view may not
    return x if x.stride(-1) == 1 else x.contiguous()


@flash_fwd_op.register_vmap
def _(info, in_dims, q, k, v, bf16_operands):
    # vmapped rows are independent batch rows: one launch over n·B
    n = info.batch_size
    out, lse = flash_fwd_op(*(_fold(x, d, n) for x, d in
                              zip((q, k, v), in_dims[:3])), bf16_operands)
    return (out.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


@torch.library.custom_op("mmef::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                 g_lse: Optional[torch.Tensor], bf16_operands: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = _flash_backward(q, k, v, o, lse, g, g_lse,
                                 _compute_dtype(bf16_operands))
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@flash_bwd_op.register_fake
def _(q, k, v, o, lse, g, g_lse, bf16_operands):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@flash_bwd_op.register_vmap
def _(info, in_dims, q, k, v, o, lse, g, g_lse, bf16_operands):
    # as the forward's rule: one K2 and one K3 launch over n·B rows; a
    # g_lse of None stays None
    n = info.batch_size
    folded = [None if x is None else _fold(x, d, n)
              for x, d in zip((q, k, v, o, lse, g, g_lse), in_dims[:7])]
    grads = flash_bwd_op(*folded, bf16_operands)
    return tuple(t.unflatten(0, (n, -1)) for t in grads), (0, 0, 0)


def _save_residuals(ctx, inputs, output):
    """What the backward of ``mmef::flash_fwd`` keeps: q, k, v and both
    outputs, and the operand mode. An output that is not used gets None as
    its cotangent, not a tensor of zeros."""
    q, k, v, bf16_operands = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.bf16_operands = bf16_operands
    ctx.set_materialize_grads(False)


def _flash_grads(ctx, g, g_lse):
    """(dq, dk, dv, None) of ``mmef::flash_fwd`` through ``mmef::flash_bwd``
    (K2 and K3), the cotangent of lse folded into Δ; none for the operand
    mode."""
    q, k, v, o, lse = ctx.saved_tensors
    if g is None:
        g = torch.zeros_like(o)
    elif g.stride(-1) != 1:
        # autograd may hand over an expanded cotangent; the kernels read
        # dO with its last dim contiguous
        g = g.contiguous()
    # the gradients are not differentiable again (no double backward)
    with torch.no_grad():
        grads = flash_bwd_op(q, k, v, o, lse, g, g_lse, ctx.bf16_operands)
    return (*grads, None)


# the operator's own gradient: a program that torch.export traces holds bare
# ``mmef::flash_fwd`` nodes, and once loaded its backward reaches K2 and K3
# through this formula, as ``_FlashAttention``'s does in eager code
torch.library.register_autograd("mmef::flash_fwd", _flash_grads,
                                setup_context=_save_residuals)


class _FlashAttention(torch.autograd.Function):
    """The forward op with the residuals (q, k, v, o, lse) saved for the
    backward op; differentiable in both outputs, and the cotangent of lse
    folds into Δ. Under torch.func.vmap both fold the vmapped axis into
    B: a gradient under vmap launches one K1, one K2 and one K3 over n·B
    rows. Its formula is the operator's (``_save_residuals``,
    ``_flash_grads``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, bf16_operands):
        return flash_fwd_op(q, k, v, bf16_operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save_residuals(ctx, inputs, output)

    @staticmethod
    def backward(ctx, g, g_lse):
        return _flash_grads(ctx, g, g_lse)


def _flash(q, k, v, compute_dtype):
    """The op itself where no gradient is wanted (so that torch.export
    traces one ``mmef::flash_fwd`` node, also under vmap), else through
    ``_FlashAttention``."""
    bf16_operands = _bf16_operands(compute_dtype)
    # a vmapped tensor does not show whether the tensor it wraps needs grad
    if torch.is_grad_enabled() and any(
            t.requires_grad or _functorch.is_functorch_wrapped_tensor(t)
            for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bf16_operands)
    return flash_fwd_op(q, k, v, bf16_operands)


def flash_attention(q, k, v, compute_dtype=torch.float32) -> torch.Tensor:
    """Non-causal blockwise attention, q (B,H,Tq,D), k/v (B,H,Tk,D);
    differentiable in q, k and v.

    ``compute_dtype=torch.bfloat16`` feeds the per-tile products bf16
    operands, with f32 sums and f32 softmax statistics."""
    return _flash(q, k, v, compute_dtype)[0]


def flash_attention_lse(q, k, v, compute_dtype=torch.float32):
    """``flash_attention`` that also returns the per-row logsumexp
    (B, H, Tq) in f32; differentiable in both outputs."""
    return _flash(q, k, v, compute_dtype)


def attention(q, k, v, min_flash_len: int = 256,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Einsum path for short sequences, flash once either length reaches
    ``min_flash_len``."""
    if q.shape[2] < min_flash_len and k.shape[2] < min_flash_len:
        return reference_attention(q, k, v)
    return flash_attention(q, k, v, compute_dtype=compute_dtype)
