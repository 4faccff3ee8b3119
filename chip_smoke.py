"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, serves MultimodalEndToEnd at
its full default width through ``Predictor`` (2-second epochs, T=512, where
all four temporal self-attention layers take the flash kernel), checks the
results, and times the kernel and the predictor. Any failed phase raises, so
the exit code is not 0 and the final line is not printed. There is no CPU
mode: without a GPU the script fails at once.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_SHAPES = [(8, 4, 256, 32), (8, 4, 512, 32)]   # ERP and PW layers, T=512
RAGGED_SHAPES = [(2, 2, 300, 333, d) for d in (16, 32, 64, 128)]
KERNEL_ATOL = 2e-5        # f32 sums in another order
BF16_ATOL = 1e-2          # p rounded to bf16 against a running max, tile by tile
LOGITS_ATOL = 1e-4
T_SERVE, T_SHORT, BATCH = 512, 250, 8
REQUEST_ROWS = (8, 5, 1)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str):
    print(f"== {name}", flush=True)


def request(n: int, T: int, seed: int) -> dict:
    r = np.random.default_rng(seed)

    def x(*shape):
        return r.standard_normal(shape).astype(np.float32)

    return dict(erp=x(n, T, 18), pw=x(n, T, 75), conn=x(n, 459),
                activation=x(n, 90), connectivity=x(n, 64))


def cuda_ms(fn, iters: int = 200) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from multimodal_eeg_fmri_tpu_torch import (
        MultimodalEndToEnd,
        Predictor,
        init_weights,
    )
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention
    from multimodal_eeg_fmri_tpu_torch.ops import _kernels
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_lse,
        flash_forward_cuda,
        flash_forward_plain,
    )

    phase("build")
    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    phase("kernel vs plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for shape, cdt, atol in (
            [((*s[:3], s[2], s[3]), torch.float32, KERNEL_ATOL)
             for s in SLICE_SHAPES]
            + [(s, torch.float32, KERNEL_ATOL) for s in RAGGED_SHAPES]
            + [((8, 4, 512, 512, 32), torch.bfloat16, BF16_ATOL)]):
        B, H, tq, tk, d = shape
        q = torch.randn(B, H, tq, d, device=dev, generator=gen)
        k = torch.randn(B, H, tk, d, device=dev, generator=gen)
        v = torch.randn(B, H, tk, d, device=dev, generator=gen)
        out_k, lse_k = flash_forward_cuda(q, k, v, cdt)
        out_p, lse_p = flash_forward_plain(q, k, v, cdt)
        torch.cuda.synchronize()
        d_out = (out_k - out_p).abs().max().item()
        d_lse = (lse_k - lse_p).abs().max().item()
        print(f"B,H,Tq,Tk,D={shape} {str(cdt)[6:]}: max|dO|={d_out:.3e} "
              f"max|dlse|={d_lse:.3e} (limit {atol:g})")
        if not (d_out <= atol and d_lse <= atol):
            fail(f"kernel disagrees with its plain version at {shape}")
        if cdt == torch.float32:
            worst = max(worst, d_out, d_lse)

    phase(f"slice: MultimodalEndToEnd defaults, Predictor(batch_size={BATCH})"
          f", T={T_SERVE}")
    model = init_weights(MultimodalEndToEnd(device=dev),
                         torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, batch_size=BATCH)
    requests = [request(n, T_SERVE, seed=10 + i)
                for i, n in enumerate(REQUEST_ROWS)]
    flash_attention.launches = flash_attention_lse.launches = 0
    probs = [predictor(**req) for req in requests]
    torch.cuda.synchronize()
    launches = flash_attention.launches + flash_attention_lse.launches
    padded_batches = sum(-(-n // BATCH) for n in REQUEST_ROWS)
    print(f"{n_params} parameters; served rows {REQUEST_ROWS}; flash_fwd "
          f"launches {launches} for {padded_batches} padded batches")
    if launches != 4 * padded_batches:
        fail(f"expected {4 * padded_batches} flash_fwd launches, "
             f"got {launches}")
    for n, p in zip(REQUEST_ROWS, probs):
        if p.shape != (n, 2) or not np.all(np.isfinite(p)):
            fail(f"probabilities of shape {p.shape}, finite: "
                 f"{np.all(np.isfinite(p))}")
        if np.abs(p.sum(-1) - 1.0).max() > 1e-5:
            fail("probabilities do not sum to 1")

    logits_kernel = Predictor(model, BATCH, return_probs=False)(**requests[0])
    plain_model = copy.deepcopy(model)
    for m in plain_model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "einsum"
    logits_plain = Predictor(plain_model, BATCH,
                             return_probs=False)(**requests[0])
    logits_cpu = Predictor(copy.deepcopy(model).cpu(), BATCH,
                           return_probs=False)(**requests[0])
    d_plain = float(np.abs(logits_kernel - logits_plain).max())
    d_cpu = float(np.abs(logits_kernel - logits_cpu).max())
    print(f"logits, kernel vs plain attention on the card: max|d|={d_plain:.3e}"
          f"; vs the CPU path: max|d|={d_cpu:.3e} (limit {LOGITS_ATOL:g})")
    if not (d_plain <= LOGITS_ATOL and d_cpu <= LOGITS_ATOL):
        fail("logits with the kernel disagree with the plain versions")

    before = flash_attention.launches
    short = predictor(**request(BATCH, T_SHORT, seed=20))
    torch.cuda.synchronize()
    if flash_attention.launches != before or not np.all(np.isfinite(short)):
        fail(f"T={T_SHORT} launched the kernel or gave non-finite output")
    print(f"T={T_SHORT}: no flash_fwd launch (the einsum route), as the auto "
          "rule says")

    phase(f"timing {card}")
    stats = predictor.benchmark(requests[0], warmup=5, iters=50)
    stats_plain = Predictor(plain_model, BATCH).benchmark(
        requests[0], warmup=5, iters=50)
    print(f"Predictor.benchmark B={BATCH} T={T_SERVE}, flash kernel: "
          f"p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms {card}")
    print(f"Predictor.benchmark B={BATCH} T={T_SERVE}, einsum attention: "
          f"p50 {stats_plain['p50_ms']:.3f} ms, p95 "
          f"{stats_plain['p95_ms']:.3f} ms {card}")
    per_forward = {"ms": 0.0, "plain_ms": 0.0}
    for B, H, T, d in SLICE_SHAPES:
        q, k, v = (torch.randn(B, H, T, d, device=dev, generator=gen)
                   for _ in range(3))
        kernel = [cuda_ms(lambda: flash_forward_cuda(q, k, v))]
        plain = [cuda_ms(lambda: flash_forward_plain(q, k, v))]
        plain.append(cuda_ms(lambda: flash_forward_plain(q, k, v)))
        kernel.append(cuda_ms(lambda: flash_forward_cuda(q, k, v)))
        ms, plain_ms = float(np.mean(kernel)), float(np.mean(plain))
        # two layers of each shape per forward
        per_forward["ms"] += 2 * ms
        per_forward["plain_ms"] += 2 * plain_ms
        print(f"flash_fwd (B,H,T,D)=({B},{H},{T},{d}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms per call {card}")

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "multimodal_eeg_fmri_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "multimodal_eeg_fmri_tpu/ops/attention.py:63",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_forward["ms"],
        "plain_ms": per_forward["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
