"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout and holds
each against its plain PyTorch version on the card: K1, the flash forward,
and K2 and K3, the flash backward (dK/dV and dQ). Then it drives the port's
two paths at the full default width of MultimodalEndToEnd with 2-second
epochs (T=512, where all four temporal self-attention layers take the flash
kernels): serving through ``Predictor``, and training through
``make_fit_fn`` (3 epochs over a 32-subject cohort). Each path runs with the
launch counts set to 0 just before it and read just after. It checks the
results, compares one train step of the kernel route with the einsum route
and with the CPU path, checks that bench.py's own step (T=250, dropout 0.3)
launches no backward kernel, and times the kernels and the steps. Any failed
phase raises, so the exit code is not 0 and the final line is not printed.
There is no CPU mode: without a GPU the script fails at once.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_SHAPES = [(8, 4, 256, 32), (8, 4, 512, 32)]   # ERP and PW layers, T=512
RAGGED_SHAPES = [(2, 2, 300, 333, d) for d in (16, 32, 64, 128)]
KERNEL_ATOL = 2e-5        # f32 sums in another order
BF16_ATOL = 1e-2          # p rounded to bf16 against a running max, tile by tile
GRAD_ATOL = 2e-4          # f32 gradients: longer sums of larger terms
GRAD_BF16_ATOL = 5e-2     # the JAX package's own tolerance for the bf16 mode
LOGITS_ATOL = 1e-4
STEP_LOSS_ATOL = 1e-5     # one train step, kernel route vs einsum route
STEP_GRAD_RTOL = 1e-4     # max |dg| over the gradient's max
T_SERVE, T_SHORT, BATCH = 512, 250, 8
REQUEST_ROWS = (8, 5, 1)
COHORT, VAL_ROWS, EPOCHS = 32, 8, 3
# published H100 SXM peaks (NVIDIA data sheet, 700 W): f32 on the CUDA cores,
# where these kernels run, and HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


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


def labelled(n: int, T: int, seed: int, dev) -> dict:
    """A cohort of n subjects on the card, half of each class."""
    data = request(n, T, seed)
    data["label"] = np.arange(n, dtype=np.int64) % 2
    data["weight"] = np.ones(n, np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in data.items()}


def zscore(inputs: dict) -> dict:
    """bench.py's in-step z-score of the EEG time series."""
    return {k: (inputs[k] - inputs[k].mean(dim=(-2, -1), keepdim=True))
            / (inputs[k].std(dim=(-2, -1), keepdim=True, correction=0) + 1e-8)
            for k in ("erp", "pw")}


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


def in_turns(a, b) -> tuple:
    """(mean of a, mean of b), timed a, b, b, a."""
    ta, tb = [a()], [b()]
    tb.append(b())
    ta.append(a())
    return float(np.mean(ta)), float(np.mean(tb))


def step_ms(step, batch, cw, iters: int = 20) -> float:
    """Host clock per train step, ending in a synchronize."""
    for _ in range(3):
        step(batch, cw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch, cw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / iters


def profile_steps(step, batch, cw, card: str, n: int = 5) -> None:
    """Device busy share and device time by op over n train steps
    (torch.profiler; reports and goes on if the trace has no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batch, cw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch, cw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0 / n

    def device_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # the kernels themselves: CPU ops also carry the device time they
    # launched, and annotated ranges (Optimizer.step) span kernels
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy_ms = sum(device_us(e) for e in events) / 1000.0 / n
    if not events:
        print(f"profile: the trace holds no device time {card}")
        return
    print(f"profile, {n} train steps B={BATCH} T={T_SERVE} kernel route: wall "
          f"{wall_ms:.3f} ms per step under the profiler, device busy "
          f"{busy_ms:.3f} ms per step ({100 * busy_ms / wall_ms:.1f}%) {card}")
    print(f"  {sum(e.count for e in events) / n:.0f} kernels per step; the "
          "most device time:")
    for e in sorted(events, key=device_us, reverse=True)[:12]:
        print(f"  {e.key[:60]:60s} {device_us(e) / 1000.0 / n:8.4f} ms/step "
              f"{e.count / n:6.1f} calls/step")


def bound_ms(kernel: str, B, H, tq, tk, d) -> tuple:
    """Least time (ms) of the kernel's work at f32 on the card, and what
    bounds it: operations (2 per multiply-add, exp not counted) over the f32
    peak, or bytes (each input read once, each output written once) over
    the memory rate."""
    bh = B * H
    q_el, k_el = bh * tq * d, bh * tk * d
    flops = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kernel] \
        * bh * tq * tk * d
    elems = {"flash_fwd": 2 * q_el + 2 * k_el + bh * tq,          # q, k, v; o, lse
             "flash_bwd_dkv": 2 * q_el + 4 * k_el + 2 * bh * tq,  # q, dO, k, v, lse, Δ; dk, dv
             "flash_bwd_dq": 3 * q_el + 2 * k_el + 2 * bh * tq}[kernel]
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, 4 * elems / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cancelled_biases(model) -> set:
    """Names of the biases whose gradient is zero up to rounding: those that
    feed a BatchNorm directly, which the norm cancels in training mode, and
    every attention's key-projection bias, which adds one constant to a
    row of logits and so cancels in the softmax."""
    from multimodal_eeg_fmri_tpu_torch.models.encoders import (
        ConvBNBlock,
        MultiScaleConv,
    )
    from multimodal_eeg_fmri_tpu_torch.models.layers import (
        MLP,
        MultiHeadAttention,
    )

    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            names.add(f"{prefix}.k_proj.bias")
        elif isinstance(m, ConvBNBlock):
            names.add(f"{prefix}.conv.bias")
        elif isinstance(m, MultiScaleConv):
            names.add(f"{prefix}.bias")
        elif isinstance(m, MLP) and m.norm == "batch":
            names |= {f"{prefix}.dense_{i}.bias" for i in range(m.n)
                      if hasattr(m, f"bn_{i}")}
    return names


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
        TrainConfig,
        init_weights,
        make_fit_fn,
    )
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
    from multimodal_eeg_fmri_tpu_torch.models.layers import (
        BatchNorm,
        MultiHeadAttention,
    )
    from multimodal_eeg_fmri_tpu_torch.ops import _kernels
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_lse,
        flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain,
        flash_bwd_dq_cuda,
        flash_bwd_dq_plain,
        flash_delta,
        flash_forward_cuda,
        flash_forward_plain,
        kernel_launches,
        reference_attention,
        reset_kernel_launches,
    )
    from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    phase("build")
    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    phase("kernel vs plain version: K1, the forward")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
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
            worst["flash_fwd"] = max(worst["flash_fwd"], d_out, d_lse)

    phase("kernel vs plain version: K2 (dK, dV) and K3 (dQ), the backward")
    for shape, cdt, atol in (
            [((*s[:3], s[2], s[3]), torch.float32, GRAD_ATOL)
             for s in SLICE_SHAPES]
            + [(s, torch.float32, GRAD_ATOL) for s in RAGGED_SHAPES]
            + [((8, 4, 512, 512, 32), torch.bfloat16, GRAD_BF16_ATOL)]):
        B, H, tq, tk, d = shape
        q = torch.randn(B, H, tq, d, device=dev, generator=gen)
        k = torch.randn(B, H, tk, d, device=dev, generator=gen)
        v = torch.randn(B, H, tk, d, device=dev, generator=gen)
        g = torch.randn(B, H, tq, d, device=dev, generator=gen)
        out, lse = flash_forward_cuda(q, k, v, cdt)
        delta = flash_delta(out, g)
        dk_k, dv_k = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, cdt)
        dq_k = flash_bwd_dq_cuda(q, k, v, g, lse, delta, cdt)
        dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse, delta, cdt)
        dq_p = flash_bwd_dq_plain(q, k, v, g, lse, delta, cdt)
        torch.cuda.synchronize()
        e_dkv = max((dk_k - dk_p).abs().max().item(),
                    (dv_k - dv_p).abs().max().item())
        e_dq = (dq_k - dq_p).abs().max().item()
        print(f"B,H,Tq,Tk,D={shape} {str(cdt)[6:]}: max|d(dK,dV)|={e_dkv:.3e}"
              f" max|d(dQ)|={e_dq:.3e} (limit {atol:g})")
        if not (e_dkv <= atol and e_dq <= atol):
            fail(f"backward kernels disagree with their plain versions at "
                 f"{shape}")
        if cdt == torch.float32:
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], e_dkv)
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e_dq)

    phase("autograd through K1+K2+K3 vs through the einsum reference")
    B, H, T, d = SLICE_SHAPES[1]
    x = torch.randn(3, B, T, H, d, device=dev, generator=gen,
                    requires_grad=True)
    q, k, v = (t.transpose(1, 2) for t in x)     # the model's strided layout
    g = torch.randn(B, H, T, d, device=dev, generator=gen)
    g_lse = torch.randn(B, H, T, device=dev, generator=gen)
    scale = 1.0 / math.sqrt(d)
    before = kernel_launches()
    for name, loss, ref in (
            ("flash_attention", lambda: (flash_attention(q, k, v) * g).sum(),
             lambda: (reference_attention(q, k, v) * g).sum()),
            ("flash_attention_lse, lse cotangent",
             lambda: sum((a * b).sum() for a, b in zip(
                 flash_attention_lse(q, k, v), (g, g_lse))),
             lambda: (reference_attention(q, k, v) * g).sum() + (torch.logsumexp(
                 torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, -1)
                 * g_lse).sum())):
        (got,) = torch.autograd.grad(loss(), x)
        (want,) = torch.autograd.grad(ref(), x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"{name} (B,H,T,D)=({B},{H},{T},{d}): max|d grad|={err:.3e} "
              f"(limit {GRAD_ATOL:g})")
        if not err <= GRAD_ATOL:
            fail(f"{name} gradient disagrees with the einsum reference")
    after = kernel_launches()
    if any(after[k] - before[k] != 2 for k in after):
        fail(f"autograd did not go through the kernels: {before} -> {after}")

    phase(f"serving path: MultimodalEndToEnd defaults, Predictor(batch_size="
          f"{BATCH}), T={T_SERVE}")
    model = init_weights(MultimodalEndToEnd(device=dev),
                         torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, batch_size=BATCH)
    requests = [request(n, T_SERVE, seed=10 + i)
                for i, n in enumerate(REQUEST_ROWS)]
    reset_kernel_launches()
    probs = [predictor(**req) for req in requests]
    torch.cuda.synchronize()
    serve_launches = kernel_launches()
    padded_batches = sum(-(-n // BATCH) for n in REQUEST_ROWS)
    print(f"{n_params} parameters; served rows {REQUEST_ROWS}; launches "
          f"{serve_launches} for {padded_batches} padded batches")
    if serve_launches != {"flash_fwd": 4 * padded_batches,
                          "flash_bwd_dkv": 0, "flash_bwd_dq": 0}:
        fail(f"expected {4 * padded_batches} flash_fwd launches and no "
             f"backward, got {serve_launches}")
    for n, p in zip(REQUEST_ROWS, probs):
        if p.shape != (n, 2) or not np.all(np.isfinite(p)):
            fail(f"probabilities of shape {p.shape}, finite: "
                 f"{np.all(np.isfinite(p))}")
        if np.abs(p.sum(-1) - 1.0).max() > 1e-5:
            fail("probabilities do not sum to 1")

    def einsum_route(m):
        for mod in m.modules():
            if isinstance(mod, MultiHeadAttention):
                mod.attn_impl = "einsum"
        return m

    logits_kernel = Predictor(model, BATCH, return_probs=False)(**requests[0])
    plain_model = einsum_route(copy.deepcopy(model))
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

    before = kernel_launches()
    short = predictor(**request(BATCH, T_SHORT, seed=20))
    torch.cuda.synchronize()
    if kernel_launches() != before or not np.all(np.isfinite(short)):
        fail(f"T={T_SHORT} launched a kernel or gave non-finite output")
    print(f"T={T_SHORT}: no kernel launch (the einsum route), as the auto "
          "rule says")

    phase(f"training path: MultimodalEndToEnd(dropout=0.0) defaults, "
          f"make_fit_fn, {COHORT} subjects + {VAL_ROWS} val rows, T={T_SERVE}"
          f", {EPOCHS} epochs")
    cfg = TrainConfig(batch_size=BATCH, num_epochs=EPOCHS, learning_rate=5e-5,
                      weight_decay=1e-5, grad_clip=1.0, loss="weighted_ce",
                      selection="val")
    train_model = init_weights(MultimodalEndToEnd(dropout=0.0, device=dev),
                               torch.Generator().manual_seed(1))
    initial = {k: p.detach().clone()
               for k, p in train_model.named_parameters()}
    cohort = labelled(COHORT, T_SERVE, seed=30, dev=dev)
    val = labelled(VAL_ROWS, T_SERVE, seed=31, dev=dev)
    class_weights = torch.ones(2, device=dev)
    fit = make_fit_fn(train_model, cfg, eval_names=("val",),
                      augment=make_eeg_augment(), preprocess=zscore)
    reset_kernel_launches()
    t0 = time.perf_counter()
    result = fit(0, cohort, {"val": val}, class_weights)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = kernel_launches()
    steps = EPOCHS * (COHORT // BATCH)
    # 4 flash layers: forward per train step and per eval, backward per step
    expected = {"flash_fwd": 4 * (steps + EPOCHS), "flash_bwd_dkv": 4 * steps,
                "flash_bwd_dq": 4 * steps}
    history = {k: v.cpu().numpy() for k, v in result.history.items()}
    print(f"fit: {steps} steps and {EPOCHS} evals in {fit_s:.2f} s; launches "
          f"{train_launches} (expected {expected})")
    print("history: " + ", ".join(f"{k}={np.array2string(v, precision=5)}"
                                  for k, v in history.items()))
    if train_launches != expected:
        fail(f"training launched {train_launches}, expected {expected}")
    if not all(np.all(np.isfinite(v)) and v.shape == (EPOCHS,)
               for v in history.values()):
        fail("non-finite or short history")
    moved = max((p.detach() - initial[k]).abs().max().item()
                for k, p in train_model.named_parameters())
    min_var = min(m.running_var.min().item() for m in train_model.modules()
                  if isinstance(m, BatchNorm))
    print(f"params moved by up to {moved:.3e}; smallest BatchNorm running "
          f"variance {min_var:.3e}; best epoch {result.best_epoch.item()}")
    if not (moved > 0 and min_var > 0):
        fail("params did not move or a BatchNorm running variance is not > 0")

    phase("one train step: kernel route vs einsum route on the card, and vs "
          "the CPU path")
    # the fusion gates' fixed dropout off, so that the three runs agree
    base = init_weights(MultimodalEndToEnd(dropout=0.0, device=dev),
                        torch.Generator().manual_seed(2))
    for m in base.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    batch = {k: v[:BATCH] for k, v in cohort.items()}
    grads, losses = {}, {}
    for name, m in (("kernel", copy.deepcopy(base)),
                    ("einsum", einsum_route(copy.deepcopy(base))),
                    ("cpu", copy.deepcopy(base).cpu())):
        step = TrainStep(m, cfg, preprocess=zscore)
        mdev = next(m.parameters()).device
        loss = step.loss({k: v.to(mdev) for k, v in batch.items()},
                         class_weights.to(mdev))
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {k: p.grad.to(dev) for k, p in m.named_parameters()}
    noisy = cancelled_biases(base)
    g_max = max(g.abs().max().item() for g in grads["einsum"].values())
    for other in ("einsum", "cpu"):
        d_loss = abs(losses["kernel"] - losses[other])
        # the heads whose logits MultimodalEndToEnd does not use get
        # exactly zero gradient on every route
        rel, worst_name = max(
            (((grads["kernel"][k] - g).abs().max()
              / g.abs().max()).nan_to_num(0.0).item(), k)
            for k, g in grads[other].items() if k not in noisy)
        d_noisy = max((grads["kernel"][k] - grads[other][k]).abs().max().item()
                      for k in noisy) / g_max
        print(f"kernel vs {other}: loss {losses['kernel']:.7f} vs "
              f"{losses[other]:.7f} (|d|={d_loss:.3e}, limit "
              f"{STEP_LOSS_ATOL:g}); gradients max|d|/max|g| per tensor "
              f"{rel:.3e} at {worst_name} (limit {STEP_GRAD_RTOL:g}); the "
              f"{len(noisy)} biases whose gradient is zero up to rounding: "
              f"max|d| / the largest gradient {d_noisy:.3e}")
        if not (d_loss <= STEP_LOSS_ATOL and rel <= STEP_GRAD_RTOL
                and d_noisy <= STEP_GRAD_RTOL):
            fail(f"the kernel route's train step disagrees with the {other} "
                 "route")

    phase(f"bench.py's own step: T={T_SHORT}, dropout 0.3")
    bench_model = init_weights(MultimodalEndToEnd(device=dev),
                               torch.Generator().manual_seed(3))
    bench_cfg = TrainConfig(loss="ce")
    bench_step = TrainStep(bench_model, bench_cfg, augment=make_eeg_augment(),
                           preprocess=zscore)
    bench_batch = labelled(BATCH, T_SHORT, seed=40, dev=dev)
    reset_kernel_launches()
    loss = bench_step(bench_batch, None, gen).item()
    torch.cuda.synchronize()
    if any(kernel_launches().values()) or not math.isfinite(loss):
        fail(f"T={T_SHORT} step launched {kernel_launches()} or gave loss "
             f"{loss}")
    print(f"T={T_SHORT}, dropout 0.3: loss {loss:.6f}, launches "
          f"{kernel_launches()} (the einsum route, as the auto rule says)")

    phase(f"timing {card}")
    stats = predictor.benchmark(requests[0], warmup=5, iters=50)
    stats_plain = Predictor(plain_model, BATCH).benchmark(
        requests[0], warmup=5, iters=50)
    print(f"Predictor.benchmark B={BATCH} T={T_SERVE}, flash kernel: "
          f"p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms {card}")
    print(f"Predictor.benchmark B={BATCH} T={T_SERVE}, einsum attention: "
          f"p50 {stats_plain['p50_ms']:.3f} ms, p95 "
          f"{stats_plain['p95_ms']:.3f} ms {card}")

    timed = {}
    for name, m in (("kernel", copy.deepcopy(base)),
                    ("einsum", einsum_route(copy.deepcopy(base)))):
        timed[name] = TrainStep(m, cfg, preprocess=zscore)
    kernel_ms, einsum_ms = in_turns(
        lambda: step_ms(timed["kernel"], batch, class_weights),
        lambda: step_ms(timed["einsum"], batch, class_weights))
    print(f"train step B={BATCH} T={T_SERVE} dropout 0: kernel route "
          f"{kernel_ms:.3f} ms, einsum route {einsum_ms:.3f} ms {card}")
    bench_ms = step_ms(lambda b, cw: bench_step(b, cw, gen), bench_batch, None)
    print(f"train step B={BATCH} T={T_SHORT} dropout 0.3 (bench.py's step): "
          f"{bench_ms:.3f} ms {card}")
    profile_steps(timed["kernel"], batch, class_weights, card)

    from torch.nn.functional import scaled_dot_product_attention as sdpa

    per_step = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0, "ops": 0.0}
                for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    for B, H, T, d in SLICE_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, d, device=dev, generator=gen)
                      for _ in range(4))
        out, lse = flash_forward_cuda(q, k, v)
        delta = flash_delta(out, g)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl)
        lib_fwd = cuda_ms(lambda: sdpa(q, k, v))
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), g, retain_graph=True))
        pairs = {
            "flash_fwd": (lambda: flash_forward_cuda(q, k, v),
                          lambda: flash_forward_plain(q, k, v), lib_fwd),
            "flash_bwd_dkv": (
                lambda: flash_bwd_dkv_cuda(q, k, v, g, lse, delta),
                lambda: flash_bwd_dkv_plain(q, k, v, g, lse, delta), lib_bwd),
            "flash_bwd_dq": (
                lambda: flash_bwd_dq_cuda(q, k, v, g, lse, delta),
                lambda: flash_bwd_dq_plain(q, k, v, g, lse, delta), lib_bwd),
        }
        for name, (kern, plain, lib_ms) in pairs.items():
            ms, plain_ms = in_turns(lambda: cuda_ms(kern),
                                    lambda: cuda_ms(plain))
            b_ms, by = bound_ms(name, B, H, T, T, d)
            # two layers of each shape per train step
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b_ms), ("library_ms", lib_ms),
                             ("ops", by == "operations")):
                per_step[name][key] += 2 * val
            print(f"{name} (B,H,T,D)=({B},{H},{T},{d}): kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                  f"library (SDPA {'forward' if name == 'flash_fwd' else 'backward, dQ+dK+dV'}) "
                  f"{lib_ms:.4f} ms per call {card}")

    replaces = {"flash_fwd": "multimodal_eeg_fmri_tpu/ops/attention.py:63",
                "flash_bwd_dkv": "multimodal_eeg_fmri_tpu/ops/attention.py:121",
                "flash_bwd_dq": "multimodal_eeg_fmri_tpu/ops/attention.py:173"}
    source = {"flash_fwd": "multimodal_eeg_fmri_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd_dkv": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dq": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu"}
    print("per train step (2 layers at T=256, 2 at T=512): " + "; ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f})"
        for k, v in per_step.items()))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source[name],
        "replaces": replaces[name],
        "launches": train_launches[name],
        "max_abs_err": worst[name],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "operations" if t["ops"] else "bytes",
        "library_ms": t["library_ms"],
    } for name, t in per_step.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
