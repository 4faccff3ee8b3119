"""The port's flash attention against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do.
On the CPU the port's wrappers run their plain PyTorch math; the kernel
itself is tested on the card by ``test_torch_port_kernel.py``. Tolerances:
f32 out and lse within 1e-5 (sums taken in another order); the bf16-operand
mode within 2e-3 (bf16 rounds each operand to 8 bits).
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages' ``ops.attention`` attribute is the dispatch function, so
# the modules are looked up by name
jax_attn = importlib.import_module("multimodal_eeg_fmri_tpu.ops.attention")
port_attn = importlib.import_module(
    "multimodal_eeg_fmri_tpu_torch.ops.attention")

REPO = Path(__file__).resolve().parent.parent

CASES = [  # (B, H, Tq, Tk, D): Tq != Tk, T not a block multiple, D in {16,32,64}
    (2, 2, 200, 333, 16),
    (1, 2, 130, 70, 32),
    (1, 3, 96, 160, 64),
]


def _qkv(B, H, tq, tk, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, tq, d), dtype=np.float32),
            r.standard_normal((B, H, tk, d), dtype=np.float32),
            r.standard_normal((B, H, tk, d), dtype=np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_lse_matches_jax(case):
    q, k, v = _qkv(*case)
    out_j, lse_j = jax_attn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out_p, lse_p = port_attn.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert lse_p.dtype == torch.float32 and lse_p.shape == case[:3]
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), atol=1e-5)


@pytest.mark.parametrize("case", CASES[:2])
def test_flash_attention_matches_jax(case):
    q, k, v = _qkv(*case, seed=1)
    out_j = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out_p = port_attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5)


def test_bf16_operand_mode_matches_jax():
    q, k, v = _qkv(1, 2, 130, 200, 32, seed=2)
    out_j, lse_j = jax_attn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        compute_dtype=jnp.bfloat16)
    out_p, lse_p = port_attn.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=2e-3)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), atol=2e-3)


def test_reference_attention_matches_jax_with_mask():
    q, k, v = _qkv(2, 2, 12, 20, 16, seed=3)
    mask = np.random.default_rng(4).random((2, 1, 12, 20)) > 0.3
    ref_j = jax_attn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask))
    ref_p = port_attn.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ref_p.numpy(), np.asarray(ref_j), atol=1e-5)


@pytest.mark.parametrize("tq,tk", [(16, 40), (16, 256), (300, 8)])
def test_attention_dispatch_on_cpu(tq, tk):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, tq, tk, 16, seed=5))
    before = port_attn.kernel_launches()
    out = port_attn.attention(q, k, v)
    ref = port_attn.reference_attention(q, k, v)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    # the CPU runs the plain math: no kernel launch is counted
    assert port_attn.kernel_launches() == before


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.flash_forward_cuda(q, k, v)


def test_port_imports_no_jax():
    code = ("import sys, chip_smoke, multimodal_eeg_fmri_tpu_torch, "
            "multimodal_eeg_fmri_tpu_torch.ops._kernels, "
            "multimodal_eeg_fmri_tpu_torch.ops.augment, "
            "multimodal_eeg_fmri_tpu_torch.ops.losses, "
            "multimodal_eeg_fmri_tpu_torch.core.config, "
            "multimodal_eeg_fmri_tpu_torch.report.metrics, "
            "multimodal_eeg_fmri_tpu_torch.train.fit, "
            "multimodal_eeg_fmri_tpu_torch.train.evaluate, "
            "multimodal_eeg_fmri_tpu_torch.train.trainer, "
            "multimodal_eeg_fmri_tpu_torch.train.resilient, "
            "multimodal_eeg_fmri_tpu_torch.core.checkpoint, "
            "multimodal_eeg_fmri_tpu_torch.data.arrays, "
            "multimodal_eeg_fmri_tpu_torch.data.raw, "
            "multimodal_eeg_fmri_tpu_torch.data.nifti, "
            "multimodal_eeg_fmri_tpu_torch.data.streaming, "
            "multimodal_eeg_fmri_tpu_torch.ops.signal, "
            "multimodal_eeg_fmri_tpu_torch.ops.schedules, "
            "multimodal_eeg_fmri_tpu_torch.core.rng, "
            "multimodal_eeg_fmri_tpu_torch.data.splits, "
            "multimodal_eeg_fmri_tpu_torch.data.normalize, "
            "multimodal_eeg_fmri_tpu_torch.data.synthetic, "
            "multimodal_eeg_fmri_tpu_torch.report.stats, "
            "multimodal_eeg_fmri_tpu_torch.report.calibration, "
            "multimodal_eeg_fmri_tpu_torch.report.conformal, "
            "multimodal_eeg_fmri_tpu_torch.report.clinical, "
            "multimodal_eeg_fmri_tpu_torch.train.cv\n"
            "bad = [m for m in ('jax', 'flax', 'optax', "
            "'multimodal_eeg_fmri_tpu', 'sklearn') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
