"""The hand-written kernels against their plain versions: the flash
attention (K1 forward, K2 dK/dV, K3 dQ) and the biquad cascade (S1,
``sosfilt``).

These tests run the CUDA kernels, which have no CPU mode: they are marked
``cuda`` and skip where there is no GPU. They import no JAX, so on a machine
with a card and without JAX they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel.py

Tolerances: f32 out and lse within 2e-5 (sums taken in another order); the
forward's bf16-operand mode within 1e-2, since the kernel rounds p to bf16
against a running max tile by tile where the plain version uses the row's
final max; bf16 outputs within 1e-2 (forward) and 5e-2 (gradients), their
own rounding. Gradients: f32 within 2e-4 (longer sums of larger terms); the
bf16-operand mode within 2e-3, since kernel and plain version round the
same operands at the same places and differ only in the order of their f32
sums (a rounding left out, such as dS unrounded before dS·K, moves dq by
1e-3 or more); with bf16 storage as well, plus one bf16 ulp of the largest
gradient, as both sides round their f32 result to bf16 on their own.
Past head dim 128 (K1, K2 and K3 on the split tensor-core kernels up to
256; past it K1 on the CUDA cores and K2, K3 on the deep tensor-core
kernels) at the same gates, each launch counted at its C entry point and
launch head dim, and K1, K2 and K3 equal bit for bit on a second call
(each block writes its rows once, its sums in a fixed order).
S1 on either schedule within 2e-5 of its sequential plain version's largest
|value| (on the sequential schedule it rounds each operation as the plain
version does, so the two should agree exactly), and equal to
``sosfilt_chunked_plain`` on the chunked one (the same roundings in the
same order); on the rule's schedule its error against the float64
recurrence at most 1.5× the sequential schedule's (the chunks carry their
start states in float64 and round them once).
"""

import math

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu_torch.data.raw import (
    DEFAULT_BANDS,
    make_raw_eeg_featurizer,
)
from multimodal_eeg_fmri_tpu_torch.data.streaming import (
    make_streaming_featurizer,
)
from multimodal_eeg_fmri_tpu_torch.ops import _kernels
from multimodal_eeg_fmri_tpu_torch.ops import signal as S
from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    WIDE_MAX_HEAD_DIM,
    _launch,
    flash_attention,
    flash_attention_lse,
    flash_backward_cuda,
    flash_backward_plain,
    flash_bwd_dkv_cuda,
    flash_bwd_dkv_plain,
    flash_bwd_dq_cuda,
    flash_bwd_dq_plain,
    flash_delta,
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
GRAD_BF16_ATOL = 2e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain versions' bf16 GEMMs sum in f32, whatever cuBLAS picks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    before = flash_forward_cuda.launches["bf16"]
    out_k, lse_k = flash_forward_cuda(q, k, v)
    assert flash_forward_cuda.launches["bf16"] == before + 1
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
    before = dict(flash_forward_cuda.launches)
    out = flash_attention(q, k, v)
    assert flash_forward_cuda.launches == {"f32": before["f32"] + 1,
                                           "bf16": before["bf16"]}
    ref, _ = flash_forward_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("member_dim", [0, 2])
def test_vmapped_members_fold_into_one_launch(cuda_device, member_dim):
    """``torch.func.vmap`` over K=5 members of the serving shape
    (8, 4, 512, 32) reaches K1 once, on the folded (40, 4, 512, 32) batch,
    and equals the plain version there; a member axis inside the tensor
    is moved and folded the same way."""
    K, B, H, T, D = 5, 8, 4, 512, 32
    q, k, v = (torch.randn(K, B, H, T, D, device=cuda_device).movedim(
        0, member_dim) for _ in range(3))
    before = dict(flash_forward_cuda.launches)
    with torch.inference_mode():
        out, lse = torch.func.vmap(flash_attention_lse,
                                   in_dims=member_dim)(q, k, v)
    assert flash_forward_cuda.launches == {"f32": before["f32"] + 1,
                                           "bf16": before["bf16"]}
    folded = [t.movedim(member_dim, 0).reshape(K * B, H, T, D)
              for t in (q, k, v)]
    out_p, lse_p = flash_forward_plain(*folded)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.reshape(K * B, H, T, D), out_p,
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(lse.reshape(K * B, H, T), lse_p, atol=2e-5,
                               rtol=0)


@pytest.mark.cuda
def test_gradient_under_vmap_raises_on_the_card(cuda_device):
    q, k, v = (torch.randn(2, 1, 2, 64, 32, device=cuda_device)
               for _ in range(3))

    def loss(q, k, v):
        return flash_attention(q, k, v).sum()

    with pytest.raises(NotImplementedError, match="no vmap rule"):
        torch.func.vmap(torch.func.grad(loss))(q, k, v)


@pytest.mark.cuda
def test_exported_program_launches_k1(cuda_device, tmp_path):
    """A ``torch.export`` program saved and loaded again calls K1 as
    ``mmef::flash_fwd``: the launch count moves inside its call."""
    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return flash_attention(q, k, v) * 2.0

    q, k, v = (torch.randn(2, 2, 300, 32, device=cuda_device)
               for _ in range(3))
    with torch.no_grad():
        program = torch.export.export(Attend(), (q, k, v))
    torch.export.save(program, tmp_path / "attend.pt2")
    loaded = torch.export.load(tmp_path / "attend.pt2").module()
    before = flash_forward_cuda.launches["f32"]
    with torch.no_grad():
        out = loaded(q, k, v)
    assert flash_forward_cuda.launches["f32"] == before + 1
    ref, _ = flash_forward_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, 2.0 * ref, atol=4e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["mixed_dtype", "head_dim", "dtype",
                                 "last_stride"])
def test_kernel_wrapper_refuses(cuda_device, bad):
    q, k, v = _qkv(cuda_device, 1, 1, 8, 8, 32)
    err = {"mixed_dtype": TypeError, "dtype": TypeError}.get(bad, ValueError)
    if bad == "mixed_dtype":
        q = q.bfloat16()
    elif bad == "head_dim":   # past the CUDA-core kernels' limit
        q, k, v = _qkv(cuda_device, 1, 1, 8, 8, WIDE_MAX_HEAD_DIM + 1)
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
                         [(torch.float32, 2e-4),
                          (torch.bfloat16, GRAD_BF16_ATOL)])
def test_backward_kernels_match_plain(cuda_device, case, compute_dtype, atol):
    q, k, v, out, lse, g = _backward_inputs(cuda_device, case, compute_dtype)
    g_lse = torch.from_numpy(np.random.default_rng(3).standard_normal(
        lse.shape, dtype=np.float32)).to(cuda_device)
    before = (flash_bwd_dkv_cuda.launches["f32"],
              flash_bwd_dq_cuda.launches["f32"])
    got = flash_backward_cuda(q, k, v, out, lse, g, g_lse, compute_dtype)
    want = flash_backward_plain(q, k, v, out, lse, g, g_lse, compute_dtype)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv_cuda.launches["f32"],
            flash_bwd_dq_cuda.launches["f32"]) == (
        before[0] + 1, before[1] + 1)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(
            a, b, atol=atol, rtol=0,
            msg=lambda m, name=name: f"{name} at (B,H,Tq,Tk,D)={case}, "
                                     f"{compute_dtype} operands: {m}")


PADDED_DIMS = (8, 12, 24, 48)   # head dims the HPO space draws, padded


@pytest.mark.cuda
@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_kernels_take_padded_head_dims(cuda_device, d, storage):
    """K1, K2 and K3 at a head dim between the instances: the wrapper pads
    to the next instance with the true scale 1/√d and slices back, so each
    holds against its plain version at d, at the gates above (bf16 storage:
    1e-2 forward, 2e-3 plus one bf16 ulp of the largest gradient)."""
    _kernels_hold_at_head_dim(cuda_device, d, storage)


# past 128: K1, K2 and K3 on the split tensor-core kernels up to 256 (160
# and 192 on the 192 instance); past it K1 on the CUDA cores at d, K2 and K3
# on the deep tensor-core kernels at d padded to a multiple of 64 (257 to
# 320; 1024 in two column slices)
WIDE_DIMS = (160, 192, 256, 257, 320, 384, 512, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_kernels_take_wide_head_dims(cuda_device, d, storage):
    """K1, K2 and K3 past head dim 128 at the padded head dims' gates:
    padded to the split tensor-core instances (``csrc/flash_fwd_split.cu``,
    ``csrc/flash_bwd_split.cu``) up to 256; past it K1 unpadded on the CUDA
    cores (``csrc/flash_wide.cu``), K2 and K3 padded to a multiple of 64 on
    the deep tensor-core kernels (``csrc/flash_bwd_deep.cu``)."""
    _kernels_hold_at_head_dim(cuda_device, d, storage)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_kernels_wide_head_dims_bf16_operands(cuda_device, d):
    """The bf16-operand mode past head dim 128, at its gates (1e-2
    forward, 2e-3 gradients); K2 and K3 give the same bits on a second
    call."""
    test_kernels_padded_head_dims_bf16_operands(cuda_device, d)
    q, k, v, out, lse, g = _backward_inputs(cuda_device, (2, 2, 130, 200, d),
                                            torch.bfloat16)
    delta = flash_delta(out, g)
    first = (*flash_bwd_dkv_cuda(q, k, v, g, lse, delta, torch.bfloat16),
             flash_bwd_dq_cuda(q, k, v, g, lse, delta, torch.bfloat16))
    again = (*flash_bwd_dkv_cuda(q, k, v, g, lse, delta, torch.bfloat16),
             flash_bwd_dq_cuda(q, k, v, g, lse, delta, torch.bfloat16))
    torch.cuda.synchronize()
    for a, b, name in zip(first, again, ("dk", "dv", "dq")):
        assert torch.equal(a, b), f"{name} at d={d} differs run to run"


def _instances(d):
    """The C entry point and launch head dim each wrapper takes at d, as
    ``_launch`` routes it (its choices are tested on the CPU,
    ``test_torch_port_head_dims.py``)."""
    return {fn: "{} D={}".format(*_launch(name, d)) for fn, name in (
        (flash_forward_cuda, "mmef_flash_fwd"),
        (flash_bwd_dkv_cuda, "mmef_flash_bwd_dkv"),
        (flash_bwd_dq_cuda, "mmef_flash_bwd_dq"))}


def _kernels_hold_at_head_dim(cuda_device, d, storage):
    """K1, K2 and K3 at head dim ``d`` against their plain versions, one
    launch of each counted at d and at the instance ``_instances`` names;
    each kernel gives the same bits on a second call."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    q, k, v = (t.to(dtype) for t in _qkv(cuda_device, 2, 3, 200, 333, d))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape, dtype=np.float32)).to(cuda_device, dtype)
    instances = _instances(d)
    before = {fn: (fn.launches_by_head_dim.get(d, 0),
                   fn.launches_by_instance.get(instances[fn], 0))
              for fn in instances}
    out_k, lse_k = flash_forward_cuda(q, k, v)
    out_p, lse_p = flash_forward_plain(q, k, v)
    delta = flash_delta(out_p, g)
    got = (*flash_bwd_dkv_cuda(q, k, v, g, lse_p, delta),
           flash_bwd_dq_cuda(q, k, v, g, lse_p, delta))
    want = (*flash_bwd_dkv_plain(q, k, v, g, lse_p, delta),
            flash_bwd_dq_plain(q, k, v, g, lse_p, delta))
    torch.cuda.synchronize()
    assert {fn: (fn.launches_by_head_dim[d] - n,
                 fn.launches_by_instance[instances[fn]] - i)
            for fn, (n, i) in before.items()} == dict.fromkeys(before,
                                                               (1, 1))
    again = (*flash_bwd_dkv_cuda(q, k, v, g, lse_p, delta),
             flash_bwd_dq_cuda(q, k, v, g, lse_p, delta))
    for a, b, name in zip((out_k, lse_k, *got),
                          (*flash_forward_cuda(q, k, v), *again),
                          ("out", "lse", "dk", "dv", "dq")):
        assert torch.equal(a, b), f"{name} at d={d} differs run to run"
    assert out_k.shape == q.shape and out_k.dtype == dtype
    atol = 2e-5 if storage == "f32" else 1e-2
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse_k, lse_p, atol=2e-5, rtol=0)
    for a, b, name in zip(got, want, ("dk", "dv", "dq")):
        assert a.shape == b.shape and a.dtype == dtype
        if storage == "f32":
            grad_atol = 2e-4
        else:
            largest = b.float().abs().max().item()
            grad_atol = GRAD_BF16_ATOL + 2.0 ** (math.floor(
                math.log2(largest)) - 7)
        torch.testing.assert_close(a.float(), b.float(), atol=grad_atol,
                                   rtol=0, msg=lambda m, name=name:
                                   f"{name} at d={d}, {storage}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", PADDED_DIMS)
def test_kernels_padded_head_dims_bf16_operands(cuda_device, d):
    """The bf16-operand mode of K1-K3 at a padded head dim, at its gates
    (1e-2 forward, 2e-3 gradients); K1 gives the same bits on a second
    call."""
    q, k, v, out, lse, g = _backward_inputs(cuda_device, (2, 2, 130, 200, d),
                                            torch.bfloat16)
    out_k, lse_k = flash_forward_cuda(q, k, v, torch.bfloat16)
    again = flash_forward_cuda(q, k, v, torch.bfloat16)
    assert torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1])
    torch.testing.assert_close(out_k, out, atol=1e-2, rtol=0)
    torch.testing.assert_close(lse_k, lse, atol=1e-2, rtol=0)
    got = flash_backward_cuda(q, k, v, out, lse, g, None, torch.bfloat16)
    want = flash_backward_plain(q, k, v, out, lse, g, None, torch.bfloat16)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_BF16_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernels_launch_past_the_grid_y_limit(cuda_device):
    """B·H = 65,600 rows of blocks, past gridDim.y's 65,535: B·H runs on the
    grid's x axis, so K1, K2 and K3 launch and agree with their plain
    versions (the batch of integrated gradients at 50 steps over 328
    subjects, or of Kernel SHAP's coalitions)."""
    case = (16400, 4, 64, 64, 32)
    q, k, v, out, lse, g = _backward_inputs(cuda_device, case, torch.float32)
    out_k, lse_k = flash_forward_cuda(q, k, v)
    torch.testing.assert_close(out_k, out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse_k, lse, atol=2e-5, rtol=0)
    got = flash_backward_cuda(q, k, v, out, lse, g)
    want = flash_backward_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0,
                                   msg=lambda m, name=name: f"{name}: {m}")


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
    before = (flash_bwd_dkv_cuda.launches["f32"],
              flash_bwd_dq_cuda.launches["f32"])
    (got,) = torch.autograd.grad(loss, x)
    (want,) = torch.autograd.grad(ref, x)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv_cuda.launches["f32"],
            flash_bwd_dq_cuda.launches["f32"]) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def _zoo_route_grads(model, inputs, labels):
    """Logits and every gradient (parameters and inputs) of one eval-mode
    forward and cross-entropy backward."""
    model.eval().zero_grad()
    x = {k: v.clone().requires_grad_() for k, v in inputs.items()}
    logits = model(**x).logits
    torch.nn.functional.cross_entropy(logits, labels).backward()
    # SmartFusionNetV4 ignores conn: it gets no gradient
    grads = {**{k: p.grad for k, p in model.named_parameters()},
             **{k: v.grad for k, v in x.items()}}
    return logits.detach(), {k: g for k, g in grads.items() if g is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SmartFusionNetV4", "TriModalFusionNetGNN"])
def test_zoo_flash_route_matches_einsum_route(cuda_device, name):
    """A forward and backward at the full widths and T=512, batch 4, of the
    two zoo models on the V4 encoders: the flash route (K1 forward, K2 and
    K3 backward, 4 temporal layers each) against the einsum route. Eval
    mode, so that BatchNorm is the affine map of its running statistics
    (training-mode statistics over 4 rows amplify f32 rounding far past
    the kernels' own). Logits within 1e-4; every gradient within 1e-4 of
    the largest gradient, and within 3e-4 of its own tensor's largest (the
    flash backward's rounding measured 1.3e-4 per tensor here, in the
    attention projections and the layers below them), but the key
    projections' biases, whose gradient the softmax cancels, and the graph
    encoder's source-score weights, whose gradient it cancels too where
    the leaky ReLU does not bend (~1e-10 on these inputs)."""
    import copy

    from multimodal_eeg_fmri_tpu_torch import init_weights
    from multimodal_eeg_fmri_tpu_torch import models as zoo
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention

    model = init_weights(getattr(zoo, name)(device=cuda_device),
                         torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, T = 4, 512
    inputs = {"erp": torch.randn(B, T, 18, device=cuda_device, generator=gen),
              "pw": torch.randn(B, T, 75, device=cuda_device, generator=gen),
              "conn": torch.rand(B, *((18, 18, 3) if "GNN" in name else (459,)),
                                 device=cuda_device, generator=gen)}
    labels = torch.arange(B, device=cuda_device) % 2
    einsum = copy.deepcopy(model)
    for m in einsum.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "einsum"
    before = {k: fn.launches["f32"] for k, fn in (
        ("fwd", flash_forward_cuda), ("dkv", flash_bwd_dkv_cuda),
        ("dq", flash_bwd_dq_cuda))}
    logits, grads = _zoo_route_grads(model, inputs, labels)
    torch.cuda.synchronize()
    assert {k: fn.launches["f32"] - before[k] for k, fn in (
        ("fwd", flash_forward_cuda), ("dkv", flash_bwd_dkv_cuda),
        ("dq", flash_bwd_dq_cuda))} == {"fwd": 4, "dkv": 4, "dq": 4}
    ref_logits, ref = _zoo_route_grads(einsum, inputs, labels)
    torch.testing.assert_close(logits, ref_logits, atol=1e-4, rtol=0)
    assert grads.keys() == ref.keys()
    g_max = max(g.abs().max().item() for g in ref.values())
    cancelled = {f"{n}.k_proj.bias" for n, m in model.named_modules()
                 if isinstance(m, MultiHeadAttention)}
    cancelled |= {k for k in ref if ".a_src_" in k}
    for k, g in ref.items():
        d = (grads[k] - g).abs().max().item()
        assert d <= 1e-4 * g_max, k
        assert k in cancelled or d <= 3e-4 * g.abs().max().item(), k


@pytest.mark.cuda
def test_long_context_flash_route_matches_einsum_route(cuda_device):
    """A 1-layer ``LongContextClassifier`` at its full width (hidden 64
    over 4 heads: D = 16) over (2, 2048, 18), in training mode at dropout
    0: the flash route (one K1 forward, one K2 and one K3 backward)
    against the einsum route, logits within 1e-4 and every gradient within
    1e-4 of the largest gradient and within 3e-4 of its own tensor's
    largest, but the key projection's bias, whose gradient the softmax
    cancels."""
    import copy

    from multimodal_eeg_fmri_tpu_torch import init_weights
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention

    model = init_weights(LongContextClassifier(num_layers=1,
                                               device=cuda_device),
                         torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    erp = torch.randn(2, 2048, 18, device=cuda_device, generator=gen)
    labels = torch.arange(2, device=cuda_device)
    einsum = copy.deepcopy(model)
    for m in einsum.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "einsum"

    def run(m):
        m.train()
        logits = m(erp=erp).logits
        torch.nn.functional.cross_entropy(logits, labels).backward()
        return logits.detach(), {k: p.grad for k, p in m.named_parameters()}

    kernels = (flash_forward_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    before = [fn.launches["f32"] for fn in kernels]
    logits, grads = run(model)
    torch.cuda.synchronize()
    assert [fn.launches["f32"] - b for fn, b in zip(kernels, before)] == [
        1, 1, 1]
    ref_logits, ref = run(einsum)
    torch.testing.assert_close(logits, ref_logits, atol=1e-4, rtol=0)
    g_max = max(g.abs().max().item() for g in ref.values())
    for k, g in ref.items():
        d = (grads[k] - g).abs().max().item()
        assert d <= 1e-4 * g_max, k
        assert k.endswith("k_proj.bias") or d <= 3e-4 * g.abs().max().item(), k


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


def _misaligned(x, how):
    """x's values in a (B,H,T,D) view whose base lies one element past a
    16-byte boundary ("base"), whose rows are D+1 elements apart
    ("stride"), or both: K1, K2 and K3 then stage it by element loads."""
    B, H, T, D = x.shape
    pitch = D + 1 if how in ("stride", "both") else D
    off = 1 if how in ("base", "both") else 0
    buf = torch.zeros(off + B * H * T * pitch, dtype=x.dtype, device=x.device)
    view = buf[off:].as_strided((B, H, T, D),
                                (H * T * pitch, T * pitch, pitch, 1))
    view.copy_(x)
    assert view.data_ptr() % 16 or (pitch * x.element_size()) % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 256, 320])
@pytest.mark.parametrize("how", ["base", "stride", "both"])
@pytest.mark.parametrize("dtype,atol,grad_atol",
                         [(torch.float32, 2e-5, 2e-4),
                          (torch.bfloat16, 1e-2, 5e-2)])
def test_kernels_take_misaligned_views(cuda_device, how, dtype, atol,
                                       grad_atol, d):
    """At d = 32 the tensor-core kernels up to 128; at 256 the split ones
    and at 320 the CUDA-core K1 and the deep K2 and K3, which take the view
    as it is (no padding copy at an instance or a multiple of 64)."""
    q, k, v = (t.to(dtype) for t in _qkv(cuda_device, 2, 2, 130, 200, d))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape, dtype=np.float32)).to(cuda_device, dtype)
    mq, mk, mv, mg = (_misaligned(t, how) for t in (q, k, v, g))
    out_k, lse_k = flash_forward_cuda(mq, mk, mv)
    out_p, lse_p = flash_forward_plain(q, k, v)
    delta = flash_delta(out_p, g)
    dk_k, dv_k = flash_bwd_dkv_cuda(mq, mk, mv, mg, lse_p, delta)
    dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse_p, delta)
    dq_k = flash_bwd_dq_cuda(mq, mk, mv, mg, lse_p, delta)
    dq_p = flash_bwd_dq_plain(q, k, v, g, lse_p, delta)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse_k, lse_p, atol=2e-5, rtol=0)
    for a, b, name in ((dk_k, dk_p, "dk"), (dv_k, dv_p, "dv"),
                       (dq_k, dq_p, "dq")):
        torch.testing.assert_close(a.float(), b.float(), atol=grad_atol,
                                   rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,plain", [
    (flash_bwd_dkv_cuda, flash_bwd_dkv_plain),
    (flash_bwd_dq_cuda, flash_bwd_dq_plain)], ids=["dkv", "dq"])
def test_backward_kernel_bf16_storage_and_operands(cuda_device, kernel,
                                                   plain):
    """K2 and K3 at the main path's widest shape with bf16 storage and
    bf16 operands (m16n8k16 on the tensor cores)."""
    q, k, v = (t.bfloat16() for t in _qkv(cuda_device, 8, 4, 512, 512, 32))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        q.shape, dtype=np.float32)).to(cuda_device, torch.bfloat16)
    out, lse = flash_forward_plain(q, k, v, torch.bfloat16)
    delta = flash_delta(out, g)
    got = kernel(q, k, v, g, lse, delta, torch.bfloat16)
    want = plain(q, k, v, g, lse, delta, torch.bfloat16)
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        largest = b.float().abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(largest)) - 7)
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=GRAD_BF16_ATOL + ulp, rtol=0)


# --- S1: the biquad cascade ------------------------------------------------

FIVE_BANDS = [(lo, hi, 4) for lo, hi in DEFAULT_BANDS.values()]
SOS_CASES = [  # (T, series per group, bands as (lo, hi, order), with zi)
    (2554, 288, [(8.0, 13.0, 4)], True),           # the featurizer's pass
    (304, 144, [(8.0, 13.0, 4)], True),   # raw-in-step's pass: T % 16 == 0
    (50, 18, FIVE_BANDS, True),                    # one stream chunk
    (37, 65, [(8.0, 13.0, 1), (20.0, 40.0, 1)], False),   # S=1, 2 groups
    (1, 1, [(8.0, 13.0, 4)], True),                # one sample, one series
    (300, 100, [(2.0, 40.0, 3)] * 3, False),
]


def _sos_inputs(device, T, Mg, bands, with_zi, seed=0):
    coeffs = S.sos_coefficients(np.stack(
        [S.butter_bandpass_sos(lo, hi, 250.0, order)[0]
         for lo, hi, order in bands]))
    G, n_sections = coeffs.shape[:2]
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((T, G * Mg), dtype=np.float32))
    zi = (torch.from_numpy(r.standard_normal((G, n_sections, 2, Mg),
                                             dtype=np.float32)).to(device)
          if with_zi else None)
    return coeffs, x.to(device), zi


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOS_CASES)
@pytest.mark.parametrize("schedule", ["rule", "sequential"])
def test_sosfilt_kernel_matches_plain(cuda_device, case, schedule):
    coeffs, x, zi = _sos_inputs(cuda_device, *case)
    chunk = None if schedule == "rule" else x.shape[0]
    before = S.sosfilt_cuda.launches
    y_k, zf_k = S.sosfilt_cuda(coeffs, x, zi, return_zf=True, chunk=chunk)
    assert S.sosfilt_cuda.launches == before + 1
    y_p, zf_p = S.sosfilt_plain(coeffs, x, zi)
    torch.cuda.synchronize()
    for got, want in ((y_k, y_p), (zf_k, zf_p)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-5 * want.abs().max().item())
    torch.testing.assert_close(S.sosfilt_cuda(coeffs, x, zi, chunk=chunk),
                               y_k, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [
    (500, 16),      # a partial last chunk of 4 steps
    (500, 48),      # of 20
    (480, 48),      # a whole last chunk
    (2554, 160),
])
@pytest.mark.parametrize("with_zi", [True, False])
def test_sosfilt_kernel_equals_chunked_plain(cuda_device, T, chunk, with_zi):
    """The chunked schedule's three kernels against the same phases in plain
    PyTorch on the card: the same roundings in the same order, so equal."""
    coeffs, x, zi = _sos_inputs(cuda_device, T, 40, FIVE_BANDS, with_zi)
    y_k, zf_k = S.sosfilt_cuda(coeffs, x, zi, return_zf=True, chunk=chunk)
    y_p, zf_p = S.sosfilt_chunked_plain(coeffs, x, zi, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=0)
    torch.testing.assert_close(zf_k, zf_p, rtol=0, atol=0)


@pytest.mark.cuda
def test_sosfilt_carries_state_across_chunks(cuda_device):
    coeffs, x, _ = _sos_inputs(cuda_device, 500, 18, [(8.0, 13.0, 4)], False)
    whole, zf = S.sosfilt_cuda(coeffs, x, None, return_zf=True, chunk=500)
    z, pieces = None, []
    for k in range(0, 500, 50):
        y, z = S.sosfilt_cuda(coeffs, x[k:k + 50], z, return_zf=True,
                              chunk=50)
        pieces.append(y)
    torch.testing.assert_close(torch.cat(pieces), whole, rtol=0, atol=0)
    torch.testing.assert_close(z, zf, rtol=0, atol=0)


@pytest.mark.cuda
def test_sosfilt_rule_schedule_against_f64_oracle(cuda_device):
    """The five default bands at the featurizer's (2554, 288), each alone on
    the rule's (chunked) schedule: its error against the float64 recurrence
    at most 1.5× the sequential schedule's, and its final state within 2e-5
    of the largest |y|."""
    T, M = 2554, 288
    coeffs, x, zi = _sos_inputs(cuda_device, T, M, FIVE_BANDS, True)
    assert S.sosfilt_schedule(T, M, 1, 4) < T
    y64, zf64 = S.sosfilt_plain(coeffs, x.double(), zi.double())
    for g in range(len(FIVE_BANDS)):
        cols = slice(g * M, (g + 1) * M)
        xg = x[:, cols].contiguous()
        zg = zi[g:g + 1].contiguous()
        y_rule, zf_rule = S.sosfilt_cuda(coeffs[g:g + 1], xg, zg,
                                         return_zf=True)
        y_seq = S.sosfilt_cuda(coeffs[g:g + 1], xg, zg, chunk=T)
        err = (y_rule - y64[:, cols]).abs().max().item()
        err_seq = (y_seq - y64[:, cols]).abs().max().item()
        peak = y64[:, cols].abs().max().item()
        assert err <= 1.5 * err_seq, (g, err, err_seq)
        assert (zf_rule[0] - zf64[g]).abs().max().item() <= 2e-5 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "rank", "strided", "sections",
                                 "groups", "zi_shape", "grad", "chunk_zero",
                                 "chunk_negative", "chunk_unaligned"])
def test_sosfilt_wrapper_refuses(cuda_device, bad):
    coeffs, x, zi = _sos_inputs(cuda_device, 40, 8, [(8.0, 13.0, 4)] * 2,
                                True)
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[None]
    elif bad == "strided":
        x = x[:, ::2]
    elif bad == "sections":
        coeffs = np.concatenate([coeffs] * 3, axis=1)      # S = 12
        zi = None
    elif bad == "groups":
        x = x[:, :15].contiguous()
        zi = None
    elif bad == "zi_shape":
        zi = zi[:, :, :, :4].contiguous()
    if bad == "grad":
        with pytest.raises(ValueError, match="not differentiable"):
            S.sosfilt_series(coeffs, x.requires_grad_(), zi)
        return
    if bad.startswith("chunk"):       # T = 40
        chunk = {"chunk_zero": 0, "chunk_negative": -16,
                 "chunk_unaligned": 24}[bad]
        with pytest.raises(ValueError, match="chunk"):
            S.sosfilt_cuda(coeffs, x, zi, chunk=chunk)
        return
    with pytest.raises(ValueError):
        S.sosfilt_series(coeffs, x, zi)


@pytest.mark.cuda
def test_featurizer_and_stream_launch_s1(cuda_device):
    """The featurizer's zero-phase band-pass launches S1 twice per call, a
    stream step once for all its bands; both agree with the CPU path."""
    raw = np.random.default_rng(7).standard_normal((2, 1000, 6),
                                                   dtype=np.float32)
    S.reset_kernel_launches()
    got = make_raw_eeg_featurizer(device=cuda_device)(raw)
    assert S.kernel_launches() == {"sosfilt": 2}
    want = make_raw_eeg_featurizer(device="cpu")(raw)
    for k, atol in (("erp", 1e-5), ("pw", 1e-5), ("conn", 1e-4)):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=atol, msg=k)
    init, step = make_streaming_featurizer(device=cuda_device)
    state = init(6)
    S.reset_kernel_launches()
    for k in range(0, 250, 50):
        state, out = step(state, raw[0, k:k + 50])
    assert S.kernel_launches() == {"sosfilt": 5} and out["ready"]
