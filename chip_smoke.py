"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, prints
each kernel instance's registers and spills (``nvcc -Xptxas -v``) and its
tensor-core instructions (``HMMA`` in ``cuobjdump -sass``), and holds each
kernel against its plain PyTorch version on the card: K1, the flash forward,
and K2 and K3, the flash backward (dK/dV and dQ). Then it drives the port's
two paths at the full default width of MultimodalEndToEnd with 2-second
epochs (T=512, where all four temporal self-attention layers take the flash
kernels): serving through ``Predictor``, and training through
``make_fit_fn`` (3 epochs over a 32-subject cohort). Each path runs with the
launch counts set to 0 just before it and read just after. It checks the
results, compares one train step of the kernel route with the einsum route
and with the CPU path, checks that bench.py's own step (T=250, dropout 0.3)
launches no backward kernel, and times the kernels (CUDA events around a
loop of calls, and the device time of their launches from torch.profiler)
and the steps.

The training stack past the basic ``fit`` runs too, at the same width and
T: K1, K2 and K3 in bf16 storage with f32 operands against their plain
versions; a mixed-precision fit (``compute_dtype="bfloat16"``: 48 bf16
launches of each kernel in the train steps, 12 f32 K1 launches in the
evaluations); one bf16 train step on the three routes; a fit with
``grad_accum=2`` and ``ema_decay=0.99``; ``fit_resumable`` crashed in its
third chunk and resumed, bit-identical to an uninterrupted run under
``torch.use_deterministic_algorithms(True)``; and ``Trainer`` for two epochs
with a checkpoint round trip. The timing phase adds the bf16 step and the
kernels' bf16-storage times.

Fault C5's card-test case (K2 and K3 with bf16 operands at
(8, 4, 512, 512, 32)) runs over 16 seeds of g_lse, its worst errors printed
against the 2e-3 gate.

The raw-signal slice runs too. S1, the biquad cascade behind ``sosfilt``
(``csrc/sosfilt.cu``, a chunked time-parallel scan in three kernels), is
built with the flash kernels, each instance's registers, spills and stack
frame printed (none may spill or keep a stack frame). At each shape the raw
phases give it, (2554, 288), (304, 144), (2554, 720) and a stream chunk's
(50, 90, five bands in one launch), the kernel on the rule's chunk length
equals ``sosfilt_chunked_plain`` bit for bit (gate a) and lies within 2e-5
of the sequential ``sosfilt_plain`` (gate b); the sequential schedule and
the rule's are timed in turns beside the bound and each one's
dependency-chain floor, with the device time at other chunk lengths; and
the five default bands at (2554, 288) hold the chunked schedule's error
against the float64 recurrence to 1.5× the sequential one's (gate c).
Then bench.py's three extras: raw-featurize (its featurizer input, card
against CPU, two S1 launches, epochs/s), fmri-roi (its 315 MB BOLD run,
card against CPU, volumes/s from host memory and device-resident), and
raw-in-step-T250 (its raw-EEG train step, timed in turns with the
featurized step); raw-e2e, raw EEG and BOLD runs of a 40-subject cohort
through ``raw_recordings_to_dataset`` and ``volumes_to_roi_features`` into a
3-epoch ``make_fit_fn`` of the full-width model and ``Predictor``; and the
streaming featurizer over a 60-s session (one S1 launch per step, the
carried filter state against one causal pass on the sequential schedule, the
features against the offline oracle, chunks/s). The line before the kernels
line holds those values (``bench_extras``), and the kernels line lists S1
beside K1-K3.

Last, the cross-validation slice (the cv phase, ``train/cv.py``): gate c
holds the SHA-256 of the splits of the three split front-ends on its
cohorts to the constant the JAX package's sklearn splits give
(``tests/test_torch_port_splits.py`` recomputes it). cv-eeg-kfold-T512
runs ``run_cv`` on TriModalFusionNetV4 at EEGConfig's widths with dropout
0 over 66 subjects in 5 stratified-group folds, 3 epochs: the K1-K3
launches must equal the counts derived from the padded fold length, the
steps and the evaluations; gate a holds ``run_cv`` to a hand loop of
``make_fit_fn`` over the same fold arrays, generators and initial weights,
bit for bit under ``torch.use_deterministic_algorithms(True)``; gate b
reruns fold 0 with the whole padded fold in one batch on the kernel route,
the einsum route and the CPU (test probabilities and best metric within
1e-4); the clinical report, the seconds per fold and per run, the steps
and fold 0's device busy share are printed. cv-eeg-pipeline-T250 runs the
JAX pipeline's own settings (T=250, dropout 0.3, augmentation) and must
launch no kernel; cv-fmri runs FMRIFusionNet over 32 subjects in 5 folds,
LOSO with subject votes and the pooled clinical report, and a 4-seed sweep.
Gate d wants finite histories, metrics and clinical values, coverage in
[0, 1] and each sweep's interval around its mean. A ``cv`` JSON line holds
the timings, and the kernels line gives K1-K3 each path's launches.
Any failed phase raises, so the exit code is not 0 and the final line is
not printed.
There is no CPU mode: without a GPU the script fails at once.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SLICE_SHAPES = [(8, 4, 256, 32), (8, 4, 512, 32)]   # ERP and PW layers, T=512
RAGGED_SHAPES = [(2, 2, 300, 333, d) for d in (16, 32, 64, 128)]
KERNEL_ATOL = 2e-5        # f32 sums in another order
BF16_ATOL = 1e-2          # p rounded to bf16 against a running max, tile by tile
GRAD_ATOL = 2e-4          # f32 gradients: longer sums of larger terms
GRAD_BF16_ATOL = 2e-3     # bf16 operands, rounded alike on both sides
LSE_ATOL = 2e-5           # lse is f32 whatever the storage
LOGITS_ATOL = 1e-4
STEP_LOSS_ATOL = 1e-5     # one train step, kernel route vs einsum route
STEP_GRAD_RTOL = 1e-4     # max |dg| over the gradient's max
# one bf16 train step, route against route: bf16 rounds in other places on
# each (the kernel's bf16 output against the einsum's bf16 logits and
# probabilities; the CPU's bf16 kernels), so the limits are measured
BF16_STEP_LOSS_ATOL = 2e-2
BF16_STEP_GRAD_RTOL = 5e-2   # max |dg| over the largest gradient
T_SERVE, T_SHORT, BATCH = 512, 250, 8
REQUEST_ROWS = (8, 5, 1)
COHORT, VAL_ROWS, EPOCHS = 32, 8, 3
ACCUM, EMA_DECAY = 2, 0.99
PROFILE_TOP = 12          # ops listed by device time in a profile
C5_CASE, C5_SEEDS = (8, 4, 512, 512, 32), 16    # fault C5's card-test case
# published H100 SXM peaks (NVIDIA data sheet, 700 W): the fastest route to
# f32-accurate products, 3xTF32 on the tensor cores (495 TFLOP/s TF32, three
# products per f32 product); bf16 products (exact in f32 accumulators); the
# fastest f32-accurate route for a product of an f32 operand with a
# bf16-stored one, which is exact in TF32 and in bf16: the f32 operand split
# in two TF32 pieces (two products) or in three bf16 pieces (three
# products), whichever is faster; and HBM3 bandwidth
PEAK_F32_ACCURATE_FLOPS, PEAK_BF16_FLOPS = 495e12 / 3, 989e12
PEAK_MIXED_FLOPS = max(495e12 / 2, PEAK_BF16_FLOPS / 3)
PEAK_BYTES = 3.35e12
# (kernel, head dim, storage, operands) of a kernel's mangled symbol
KERNEL_SYMBOL = re.compile(r"(flash_fwd|flash_bwd_dkv|flash_bwd_dq)_kernel"
                           r"ILi(\d+)E(f|13__nv_bfloat16)Lb([01])E")
MMA_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")  # tensor cores
# S1's three kernels (csrc/sosfilt.cu), by phase and sections
S1_SYMBOL = re.compile(r"sosfilt_(local|carry|rerun)_kernelILi(\d+)E")
S1_KERNELS = ("sosfilt_local", "sosfilt_carry", "sosfilt_rerun")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


T_START = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


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


def kernel_instance(symbol: str):
    """(kernel, D, storage, operands) of a mangled kernel symbol, or None."""
    m = KERNEL_SYMBOL.search(symbol)
    if m is None:
        return None
    return (m[1], int(m[2]), "f32" if m[3] == "f" else "bf16",
            "bf16" if m[4] == "1" else "f32")


def s1_instance(symbol: str):
    """(kernel, sections) of one of S1's mangled kernel symbols, or None."""
    m = S1_SYMBOL.search(symbol)
    return None if m is None else (f"sosfilt_{m[1]}", int(m[2]))


def s1_faults(resources: dict) -> list:
    """What is wrong with S1's build, from ``parse_ptxas(text, s1_instance)``:
    an instance of its three kernels for S = 1..8 missing, or one that
    spills or has a stack frame (its coefficients, state and tiles are meant
    to live in registers)."""
    wanted = {(k, n) for k in S1_KERNELS for n in range(1, 9)}
    faults = []
    if missing := sorted(wanted - set(resources)):
        faults.append(f"S1 instances missing from ptxas: {missing}")
    if local := sorted(i for i in wanted & set(resources)
                       if any(resources[i][1:4])):
        faults.append(f"S1 instances with spills or a stack frame: {local}")
    return faults


def parse_ptxas(text: str, instance=kernel_instance) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes, stack
    frame bytes)} from the output of ``nvcc -Xptxas -v``."""
    regs, frames = {}, {}
    entry = props = None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = instance(m[1])
        elif m := re.search(r"Function properties for (\S+)", line):
            props = instance(m[1])
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                             r"stores, (\d+) bytes spill loads", line)) and props:
            frames[props] = (int(m[2]), int(m[3]), int(m[1]))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            regs[entry] = int(m[1])
    return {k: (r, *frames.get(k, (0, 0, 0))) for k, r in regs.items()}


def count_hmma(sass: str) -> dict:
    """{instance: HMMA instructions} from the output of ``cuobjdump -sass``."""
    counts, current = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = kernel_instance(m[1])
            if current:
                counts[current] = 0
        elif current and re.search(r"\bHMMA\b", line):
            counts[current] += 1
    return counts


def find_cuobjdump(nvcc: str) -> str:
    """``cuobjdump`` beside nvcc, else the one in Triton's package."""
    beside = Path(nvcc).parent / "cuobjdump"
    if beside.is_file():
        return str(beside)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        bundled = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                   / "cuobjdump")
        if bundled.is_file():
            return str(bundled)
    fail("cuobjdump is neither beside nvcc nor in triton/backends/nvidia/bin")


def build_and_inspect(_kernels) -> None:
    """Build the library, with ``-Xptxas -v`` compiles of the same sources
    running beside the build; print every instance's registers, spills and
    HMMA count, and fail where ``tensor_core_faults`` finds a fault."""
    nvcc = _kernels.find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        verbose = [subprocess.Popen(
            [nvcc, *_kernels.COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sorted(_kernels.CSRC.glob("*.cu"))]
        lib = _kernels.build()
        outputs = [p.communicate()[0] for p in verbose]
    if any(p.returncode != 0 for p in verbose):
        fail("nvcc -Xptxas -v failed:\n" + "\n".join(outputs))
    _kernels.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    resources = parse_ptxas("\n".join(outputs))
    sass = subprocess.run([find_cuobjdump(nvcc), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hmma = count_hmma(sass)
    for inst in sorted(resources):
        regs, st, ld, _ = resources[inst]
        print(f"{inst[0]} D={inst[1]} {inst[2]} storage, {inst[3]} operands: "
              f"{regs} registers, spill stores/loads {st}/{ld} bytes, "
              f"{hmma.get(inst, 0)} HMMA")
    if faults := tensor_core_faults(resources, hmma):
        fail("; ".join(faults))
    s1 = parse_ptxas("\n".join(outputs), s1_instance)
    for inst in sorted(s1):
        regs, st, ld, frame = s1[inst]
        print(f"{inst[0]} S={inst[1]}: {regs} registers, spill stores/loads "
              f"{st}/{ld} bytes, stack frame {frame} bytes")
    if faults := s1_faults(s1):
        fail("; ".join(faults))


def c5_sweep(dev) -> None:
    """The card test ``test_backward_kernels_match_plain`` at its case of
    fault C5 (bf16 operands, f32 storage, (B,H,Tq,Tk,D) = (8,4,512,512,32)):
    the test's inputs from numpy seeds, with g_lse drawn from each of
    ``C5_SEEDS`` seeds; the worst dQ, dK and dV errors against the plain
    version, held to the test's 2e-3."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_backward_cuda,
        flash_backward_plain,
        flash_forward_plain,
    )

    B, H, tq, tk, d = C5_CASE
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.standard_normal(shape, dtype=np.float32))
               .to(dev) for shape in ((B, H, tq, d), (B, H, tk, d),
                                      (B, H, tk, d)))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape, dtype=np.float32)).to(dev)
    out, lse = flash_forward_plain(q, k, v, torch.bfloat16)
    worst = dict.fromkeys(("dq", "dk", "dv"), (-1.0, -1))
    for seed in range(C5_SEEDS):
        g_lse = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            lse.shape, dtype=np.float32)).to(dev)
        got = flash_backward_cuda(q, k, v, out, lse, g, g_lse, torch.bfloat16)
        want = flash_backward_plain(q, k, v, out, lse, g, g_lse,
                                    torch.bfloat16)
        torch.cuda.synchronize()
        for name, a, b in zip(worst, got, want):
            err = (a - b).abs().max().item()
            if err > worst[name][0]:
                worst[name] = (err, seed)
    print("C5 sweep, worst over the seeds: " + ", ".join(
        f"{n} {e:.3e} (seed {s})" for n, (e, s) in worst.items())
        + f" (limit {GRAD_BF16_ATOL:g})")
    if any(e > GRAD_BF16_ATOL for e, _ in worst.values()):
        fail("fault C5: a backward kernel exceeds its bf16-operand gate")


def tensor_core_faults(resources: dict, hmma: dict) -> list:
    """What keeps the build off the tensor cores, from ``parse_ptxas`` and
    ``count_hmma``: an instance of a kernel in MMA_KERNELS missing from
    either, with no HMMA instruction, or with spills at D=32."""
    wanted = {(k, d, s, o) for k in MMA_KERNELS for d in (16, 32, 64, 128)
              for s in ("f32", "bf16") for o in ("f32", "bf16")}
    if missing := sorted(wanted - (set(resources) & set(hmma))):
        return [f"instances missing from ptxas or SASS: {missing}"]
    faults = []
    if no_mma := sorted(i for i in wanted if hmma[i] == 0):
        faults.append(f"no HMMA instruction in {no_mma}")
    if spilled := sorted(i for i in wanted
                         if i[1] == 32 and any(resources[i][1:3])):
        faults.append(f"spills at D=32 in {spilled}")
    return faults


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
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


def _device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def device_events(prof) -> list:
    """The kernels of a trace: CPU ops also carry the device time they
    launched, and annotated ranges (Optimizer.step) span kernels."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def device_profile(fn, n: int = 50, attempts: int = 3) -> tuple:
    """(mean device time of one call in ms, device kernels per call), from
    torch.profiler over ``n`` calls: each kernel's mean time times the
    number of times one call launches it, its count over ``n`` rounded. A
    trace of a short window can lose a launch or two at its start (48 of 50
    recorded, on the H100), which a plain sum over ``n`` would count as a
    shorter call, and now and then comes back with no device event at all:
    it is then taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms, kernels = per_call_device_ms(
            [(e.count, _device_us(e)) for e in device_events(prof)], n)
        if ms > 0:
            return ms, kernels
    fail("the profiler recorded no device time")


def per_call_device_ms(kernels: list, n: int) -> tuple:
    """(ms, kernels) of one of ``n`` calls from (count, device us) per
    kernel in a trace: each kernel's mean time times round(count / n)."""
    per_call = [(round(count / n), us / count) for count, us in kernels
                if count]
    return (sum(k * t for k, t in per_call) / 1000.0,
            sum(k for k, _ in per_call))


def device_ms(fn, n: int = 50) -> float:
    """Mean device time of one call (``device_profile``)."""
    return device_profile(fn, n)[0]


def profile_calls(fn, label: str, card: str, n: int = 5):
    """Device busy share and device time by op over n calls of ``fn``
    (torch.profiler); returns the busy share, or None (and goes on) if the
    trace has no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0 / n

    events = device_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1000.0 / n
    if not events:
        print(f"profile: the trace holds no device time {card}")
        return None
    print(f"profile, {label}: wall {wall_ms:.3f} ms per call under the "
          f"profiler, device busy {busy_ms:.3f} ms per call "
          f"({100 * busy_ms / wall_ms:.1f}%) {card}")
    print(f"  {sum(e.count for e in events) / n:.0f} kernels per call; the "
          "most device time:")
    for e in sorted(events, key=_device_us, reverse=True)[:PROFILE_TOP]:
        print(f"  {e.key[:60]:60s} {_device_us(e) / 1000.0 / n:8.4f} ms/call "
              f"{e.count / n:6.1f} calls/call")
    return busy_ms / wall_ms


def bound_ms(kernel: str, B, H, tq, tk, d, storage: str = "f32") -> tuple:
    """Least time (ms) of the kernel's work, f32-accurate, on the card, and
    what bounds it: operations (2 per multiply-add, exp not counted) over
    the peak rate for their operands' type, whatever route the kernel takes,
    or bytes (each input read once, each output written once) over the
    memory rate. With f32 storage every product runs at the 3xTF32 rate;
    with bf16 storage the products of two stored tensors (S = QKᵀ, dP =
    dO·Vᵀ) are exact at the bf16 rate and those of an f32 operand (P, dS)
    with a stored one at ``PEAK_MIXED_FLOPS``; the stored tensors take 2
    bytes, lse and Δ 4."""
    bh = B * H
    q_el, k_el = bh * tq * d, bh * tk * d
    products = bh * tq * tk * d * 2          # flops of one product
    stored, mixed = {"flash_fwd": (1, 1), "flash_bwd_dkv": (2, 2),
                     "flash_bwd_dq": (2, 1)}[kernel]
    if storage == "f32":
        stored, mixed = 0, stored + mixed
    t_ops = products * (stored / PEAK_BF16_FLOPS + mixed / (
        PEAK_F32_ACCURATE_FLOPS if storage == "f32" else PEAK_MIXED_FLOPS))
    size = 4 if storage == "f32" else 2
    elems, stats = {
        "flash_fwd": (2 * q_el + 2 * k_el, bh * tq),          # q, k, v, o; lse
        "flash_bwd_dkv": (2 * q_el + 4 * k_el, 2 * bh * tq),  # q, dO, k, v, dk, dv; lse, Δ
        "flash_bwd_dq": (3 * q_el + 2 * k_el, 2 * bh * tq)}[kernel]
    t_bytes = (size * elems + 4 * stats) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def total_launches() -> dict:
    """Each flash kernel's launches since the last reset, both storage
    dtypes summed."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import kernel_launches

    return {k: sum(n.values()) for k, n in kernel_launches().items()}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def grad_limit_bf16(largest: float) -> float:
    """A bf16-storage gradient's limit against its plain version: the f32
    limit plus one bf16 ulp of the largest gradient, since both round their
    f32 sums to bf16 once."""
    return GRAD_ATOL + bf16_ulp(largest)


class InjectedCrash(Exception):
    pass


def crashing(augment, calls: int):
    """``augment`` that raises ``InjectedCrash`` at its call ``calls + 1``."""
    count = [0]

    def wrapper(generator, batch):
        count[0] += 1
        if count[0] > calls:
            raise InjectedCrash(f"injected crash at augment call {count[0]}")
        return augment(generator, batch)

    return wrapper


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def max_diff(a: dict, b: dict) -> float:
    """The largest |a − b| over the tensors of two dicts with equal keys."""
    if set(a) != set(b):
        fail(f"state keys differ: {sorted(set(a) ^ set(b))}")
    return max(((a[k].double().cpu() - b[k].double().cpu()).abs().max().item()
                for k in a), default=0.0)


def einsum_route(m):
    """``m`` with every attention layer on the einsum route (no kernel)."""
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention

    for mod in m.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.attn_impl = "einsum"
    return m


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


# --- the raw-signal slice: S1 and the phases of bench.py's extras ----------

S1_REPLACES = "multimodal_eeg_fmri_tpu/ops/signal.py:137 sosfilt (lax.scan)"
S1_SOURCE = "multimodal_eeg_fmri_tpu_torch/csrc/sosfilt.cu"
S1_RTOL = 2e-5              # of the plain version's largest |value|
PEAK_F32_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
OP_CYCLES = 4               # latency of one dependent f32 operation
F64_OP_CYCLES = 8           # of one dependent f64 operation (assumed)
S1_F64_RATIO = 1.5          # chunked vs sequential error, against f64
S1_SWEEP = (16, 32, 48, 64, 96, 128, 256)   # chunk lengths timed beside L
FS, EPOCH = 250.0, 250
RAW_N, RAW_T, CHANNELS = 16, 2500, 18          # bench.py's featurizer input
BOLD_SHAPE, N_ROIS = (64, 64, 40, 120), 90     # bench.py's BOLD run, atlas
STREAM_CHUNK, STREAM_SECONDS = 50, 60
FEATURE_GATES = {"erp": 1e-5, "pw": 1e-4, "conn": 1e-4}   # card vs CPU
ROI_RTOL = 1e-5


def s1_launches() -> int:
    from multimodal_eeg_fmri_tpu_torch.ops.signal import kernel_launches

    return kernel_launches()["sosfilt"]


def reset_all_launches() -> None:
    """Every kernel's launch count to 0: K1-K3 and S1."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        reset_kernel_launches as reset_flash,
    )
    from multimodal_eeg_fmri_tpu_torch.ops.signal import (
        reset_kernel_launches as reset_s1,
    )

    reset_flash()
    reset_s1()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


def s1_bound_ms(T: int, M: int, S: int, state_in: bool, state_out: bool
                ) -> tuple:
    """Least time (ms) of S1's work and what bounds it: the bytes (x read
    and y written once, the (S, 2, M) state read and written if present)
    over the memory rate, or the 9 operations of each biquad step (5
    multiplies, 4 adds) over the f32 peak of the CUDA cores."""
    n_bytes = 4 * (2 * T * M + (int(state_in) + int(state_out)) * 2 * S * M)
    t_bytes, t_ops = n_bytes / PEAK_BYTES, 9 * S * T * M / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def s1_cases(dev) -> list:
    """S1's shapes on the main path, as (name, coeffs, x, zi, zf, timed).
    The featurizer's passes through the alpha cascade, each from the steady
    state scaled by the first sample, as ``sosfiltfilt`` starts it, over
    T + 2·27 samples of odd padding and N recordings × 18 channels:
    raw-featurize's (2554, 288), N=16 at T=2500; raw-in-step's (304, 144),
    N=8 at T=250, where T is a multiple of the kernel's tile of 16 steps;
    raw-e2e's (2554, 720), N=40. And one stream chunk (50, 90), 5 bands ×
    18 channels in one launch, from the state a previous chunk left,
    returning the final state. The plain version is timed at the first and
    the last."""
    from multimodal_eeg_fmri_tpu_torch.data.raw import DEFAULT_BANDS
    from multimodal_eeg_fmri_tpu_torch.ops import signal as S

    r = np.random.default_rng(50)
    sos, zi = S.butter_bandpass_sos(8.0, 13.0, FS, 4)
    alpha = S.sos_coefficients(sos)[None]

    def featurizer_pass(n: int, t: int) -> tuple:
        x = torch.from_numpy(r.standard_normal(
            (t + 54, n * CHANNELS), dtype=np.float32)).to(dev)
        z = (torch.as_tensor(zi, dtype=torch.float32, device=dev)
             [None, :, :, None] * x[0]).contiguous()
        return alpha, x, z, False

    coeffs = S.sos_coefficients(np.stack(
        [S.butter_bandpass_sos(lo, hi, FS, 4)[0]
         for lo, hi in DEFAULT_BANDS.values()]))
    chunks = torch.from_numpy(r.standard_normal(
        (2, STREAM_CHUNK, CHANNELS), dtype=np.float32)).to(dev)
    _, z_prev = S.sosfilt_plain(coeffs, chunks[0].repeat(1, len(coeffs)))
    return [("featurizer pass", *featurizer_pass(RAW_N, RAW_T), True),
            ("raw-in-step pass", *featurizer_pass(BATCH, T_SHORT), False),
            ("raw-e2e pass", *featurizer_pass(COHORT + VAL_ROWS, RAW_T),
             False),
            ("stream chunk", coeffs, chunks[1].repeat(1, len(coeffs)),
             z_prev.contiguous(), True, True)]


def s1_chain_ms(T: int, L: int, S: int, clock: float) -> float:
    """S1's dependency-chain floor in ms, worked out, not measured: each
    time step of a section waits on about 4 dependent f32 operations of the
    step before (out → z0 → out), and the S sections run in a pipeline
    beside it, 2 operations apart, at ``OP_CYCLES`` each. The sequential
    schedule (L >= T) walks 4·T + 2·S of them; the chunked one 4·2·L + 2·S
    (a chunk's local pass and its rerun) plus the carry's C − 1 steps of
    2·S + 1 dependent f64 operations (a multiply, then the adds of a row)
    at ``F64_OP_CYCLES``."""
    if L >= T:
        return 1e3 * (4 * T + 2 * S) * OP_CYCLES / clock
    carry = (-(-T // L) - 1) * (2 * S + 1) * F64_OP_CYCLES
    return 1e3 * ((4 * 2 * L + 2 * S) * OP_CYCLES + carry) / clock


def s1_phase(dev, card: str) -> dict:
    """S1 at the main path's shapes. Gate a: the kernel on the rule's
    schedule equals ``sosfilt_chunked_plain`` bit for bit; gate b: it lies
    within ``S1_RTOL`` of the sequential plain version's largest |value|.
    Then the sequential schedule (chunk = T, one thread per series) and the
    rule's, in turns: CUDA events, the profiler's device time and kernels
    per call, beside the bound and each schedule's chain floor; the plain
    version's time where the case is marked for it; and the device and
    events time at other chunk lengths, against which the rule was fitted,
    where it chose the chunked schedule and at raw-in-step's shape, where
    it did not."""
    from multimodal_eeg_fmri_tpu_torch.ops import signal as S

    clock = max_sm_clock_hz()
    report, worst = {}, 0.0
    for name, coeffs, x, zi, zf, plain_timed in s1_cases(dev):
        T, M = x.shape
        G, n_sections = coeffs.shape[:2]
        L = min(S.sosfilt_schedule(T, M, G, n_sections), T)
        y_k, zf_k = S.sosfilt_cuda(coeffs, x, zi, return_zf=True)
        y_c, zf_c = S.sosfilt_chunked_plain(coeffs, x, zi)
        y_p, zf_p = S.sosfilt_plain(coeffs, x, zi)
        torch.cuda.synchronize()
        same = torch.equal(y_k, y_c) and torch.equal(zf_k, zf_c)
        errs = [((a - b).abs().max().item(), b.abs().max().item())
                for a, b in ((y_k, y_p), (zf_k, zf_p))]
        worst = max(worst, *(e for e, _ in errs))
        print(f"S1 {name} (T, M)=({T}, {M}), G={G}, S={n_sections}, rule's "
              f"L={L} ({-(-T // L)} chunks): gate a, equal to "
              f"sosfilt_chunked_plain: {same}; gate b, against sosfilt_plain:"
              f" max|dy|={errs[0][0]:.3e} at max|y|={errs[0][1]:.3e}, "
              f"max|dzf|={errs[1][0]:.3e} at max|zf|={errs[1][1]:.3e} "
              f"(limit {S1_RTOL:g} of the largest)")
        if not same:
            fail(f"S1 differs from sosfilt_chunked_plain at {(T, M)}")
        if not all(e <= S1_RTOL * peak for e, peak in errs):
            fail(f"S1 disagrees with its plain version at {(T, M)}")

        def kern(chunk):
            return lambda: S.sosfilt_cuda(coeffs, x, zi, return_zf=zf,
                                          chunk=chunk)

        seq_ms, rule_ms = in_turns(lambda: cuda_ms(kern(T)),
                                   lambda: cuda_ms(kern(None)))
        seq_dev, seq_kernels = device_profile(kern(T))
        rule_dev, rule_kernels = device_profile(kern(None))
        b_ms, by = s1_bound_ms(T, M, n_sections, True, zf)
        print(f"S1 {name}: sequential {seq_ms:.4f} ms (device {seq_dev:.4f} "
              f"ms, {seq_kernels:g} kernels), rule's L={L} {rule_ms:.4f} ms "
              f"(device {rule_dev:.4f} ms, {rule_kernels:g} kernels): "
              f"{seq_dev / rule_dev:.2f}x by device time; bound "
              f"{b_ms:.5f} ms ({by}); chain floor sequential "
              f"{s1_chain_ms(T, T, n_sections, clock):.4f} ms, rule's "
              f"{s1_chain_ms(T, L, n_sections, clock):.4f} ms ({OP_CYCLES} "
              f"cycles an f32 and {F64_OP_CYCLES} an f64 operation at "
              f"{clock / 1e9:.2f} GHz; worked out, not measured); library "
              f"none; per call {card}")
        report[name] = {"shape": [T, M], "groups": G, "sections": n_sections,
                        "chunk": L, "max_abs_err": max(e for e, _ in errs),
                        "ms": rule_ms, "device_ms": rule_dev,
                        "device_kernels": rule_kernels,
                        "sequential_ms": seq_ms,
                        "sequential_device_ms": seq_dev,
                        "bound_ms": b_ms, "bound_by": by}
        if L < T or name == "raw-in-step pass":   # where the rule chose
            sweep = {c: (device_ms(kern(c), n=20), cuda_ms(kern(c), iters=50))
                     for c in S1_SWEEP if c < T}
            print(f"S1 {name}: by chunk length, device ms / events ms "
                  + ", ".join(f"{c}: {d:.4f} / {e:.4f}"
                              for c, (d, e) in sweep.items())
                  + f" (rule's {L}) {card}")
        if plain_timed:
            report[name]["plain_ms"] = in_turns(
                lambda: cuda_ms(kern(None)),
                lambda: cuda_ms(lambda: S.sosfilt_plain(coeffs, x, zi),
                                iters=max(2, 20000 // T), warmup=1))[1]
            print(f"S1 {name}: plain {report[name]['plain_ms']:.4f} ms per "
                  f"call {card}")
    report["max_abs_err"] = worst
    report["bands"] = s1_band_gate(dev)
    return report


def s1_band_gate(dev) -> dict:
    """Gate c: the five default bands at the featurizer's (2554, 288), each
    from the steady state scaled by its first sample: the kernel's error on
    the rule's schedule against the float64 recurrence (``sosfilt_plain`` on
    float64 tensors, on the card) at most ``S1_F64_RATIO`` × the sequential
    schedule's."""
    from multimodal_eeg_fmri_tpu_torch.data.raw import DEFAULT_BANDS
    from multimodal_eeg_fmri_tpu_torch.ops import signal as S

    T, M = RAW_T + 54, RAW_N * CHANNELS
    x = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (T, M), dtype=np.float32)).to(dev)
    designs = [S.butter_bandpass_sos(lo, hi, FS, 4)
               for lo, hi in DEFAULT_BANDS.values()]
    coeffs = S.sos_coefficients(np.stack([sos for sos, _ in designs]))
    zi = torch.stack([torch.as_tensor(z, dtype=torch.float32, device=dev)
                      [:, :, None] * x[0] for _, z in designs]).contiguous()
    y64, _ = S.sosfilt_plain(coeffs, x.repeat(1, len(designs)).double(),
                             zi.double())
    L = S.sosfilt_schedule(T, M, 1, coeffs.shape[1])
    out = {}
    for g, band in enumerate(DEFAULT_BANDS):
        want = y64[:, g * M:(g + 1) * M]
        errs = [(S.sosfilt_cuda(coeffs[g:g + 1], x, zi[g:g + 1], chunk=c)
                 - want).abs().max().item() for c in (None, T)]
        peak = want.abs().max().item()
        out[band] = {"rule": errs[0], "sequential": errs[1], "peak": peak}
        print(f"gate c, {band} at ({T}, {M}), L={L}: against the f64 "
              f"recurrence, rule's schedule {errs[0]:.3e}, sequential "
              f"{errs[1]:.3e} ({errs[0] / errs[1]:.2f}x, limit "
              f"{S1_F64_RATIO:g}x) at max|y|={peak:.3e}")
        if errs[0] > S1_F64_RATIO * errs[1]:
            fail(f"S1's chunked schedule loses accuracy in the {band} band")
    return out


def raw_featurize_phase(dev, card: str) -> dict:
    """bench.py's bench_eeg_featurizer on the port: N=16, T=2500, C=18 at
    250 Hz, 1-s epochs, the 5 default bands, nperseg 128; the card's output
    against the CPU path's, S1's launches, epochs/s."""
    from multimodal_eeg_fmri_tpu_torch.data.raw import make_raw_eeg_featurizer

    raw_np = np.random.default_rng(1).standard_normal(
        (RAW_N, RAW_T, CHANNELS), dtype=np.float32)
    featurize = make_raw_eeg_featurizer(fs=FS, epoch_len=EPOCH, device=dev)
    raw = torch.from_numpy(raw_np).to(dev)
    reset_all_launches()
    got = featurize(raw)
    torch.cuda.synchronize()
    launches = s1_launches()
    print(f"featurize {tuple(raw.shape)}: S1 launches {launches} (expected "
          f"2), flash launches {total_launches()}; shapes "
          f"{ {k: tuple(v.shape) for k, v in got.items()} }")
    if launches != 2 or any(total_launches().values()):
        fail("the featurizer did not launch S1 twice (and nothing else)")
    want = make_raw_eeg_featurizer(fs=FS, epoch_len=EPOCH, device="cpu")(raw_np)
    errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in want}
    errs["pw"] /= want["pw"].abs().max().item()
    print("card vs CPU: " + ", ".join(
        f"{k} {v:.3e} (limit {FEATURE_GATES[k]:g}"
        f"{', of the largest' if k == 'pw' else ''})" for k, v in errs.items()))
    if any(v > FEATURE_GATES[k] for k, v in errs.items()):
        fail("the card's features disagree with the CPU path's")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        featurize(raw)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    epochs_per_s = RAW_N * (RAW_T // EPOCH) / best
    print(f"eeg_epochs_per_sec {epochs_per_s:.1f} (best of 3: {best * 1e3:.3f}"
          f" ms per call of {RAW_N * (RAW_T // EPOCH)} epochs) {card}")
    profile_calls(lambda: featurize(raw), f"featurize {tuple(raw.shape)}",
                  card, n=3)
    return {"eeg_epochs_per_sec": epochs_per_s, "launches": launches}


def fmri_roi_phase(dev, card: str) -> dict:
    """bench.py's bench_fmri_volumes on the port: a 64×64×40 BOLD run of 120
    volumes (315 MB f32) and a 90-ROI atlas through volumes_to_roi_features,
    against the CPU path; volumes/s from host memory and device-resident."""
    from multimodal_eeg_fmri_tpu_torch.data.nifti import (
        _roi_pipeline,
        volumes_to_roi_features,
    )

    r = np.random.default_rng(2)
    bold = r.standard_normal(BOLD_SHAPE, dtype=np.float32)
    atlas = r.integers(0, N_ROIS + 1, BOLD_SHAPE[:3]).astype(np.int32)
    T_vol = BOLD_SHAPE[-1]
    reset_all_launches()
    got = volumes_to_roi_features(bold, atlas, n_rois=N_ROIS, device=dev)
    want = volumes_to_roi_features(bold, atlas, n_rois=N_ROIS, device="cpu")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"ROI features {got.shape}: card vs CPU max|d| / max|CPU| "
          f"{rel:.3e} (limit {ROI_RTOL:g}); launches S1 {s1_launches()}, "
          f"flash {total_launches()} (none expected)")
    if not (rel <= ROI_RTOL and np.all(np.isfinite(got))):
        fail("the card's ROI features disagree with the CPU path's")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        volumes_to_roi_features(bold, atlas, n_rois=N_ROIS, device=dev)
        best = min(best, time.perf_counter() - t0)
    # device-resident: the input perturbed in each repetition and the
    # result read back, as bench.py times it
    flat = torch.from_numpy(np.moveaxis(bold, -1, 0).reshape(T_vol, -1)).to(dev)
    labels = torch.from_numpy(atlas.reshape(-1)).to(dev)
    _roi_pipeline(flat, labels, N_ROIS)
    torch.cuda.synchronize()
    best_dev = float("inf")
    for i in range(1, 4):
        t0 = time.perf_counter()
        float(_roi_pipeline(flat + 1e-3 * i, labels, N_ROIS).ravel()[0])
        best_dev = min(best_dev, time.perf_counter() - t0)
    rates = {"host": T_vol / best, "device": T_vol / best_dev}
    print(f"fmri_volumes_per_sec host {rates['host']:.1f} ({best * 1e3:.3f} ms "
          f"per run), device-resident {rates['device']:.1f} "
          f"({best_dev * 1e3:.3f} ms per run) {card}")
    profile_calls(lambda: _roi_pipeline(flat, labels, N_ROIS),
                  "ROI pipeline, device-resident", card, n=3)
    return rates


def raw_e2e_phase(dev, cfg, zscore_fn) -> dict:
    """The slice through its entry points: raw EEG of a 32-subject cohort
    and 8 validation subjects → raw_recordings_to_dataset; each subject's
    BOLD run → volumes_to_roi_features (one 315 MB run on the host at a
    time); make_fit_fn trains MultimodalEndToEnd(pw_channels=90,
    activation_features=180) for 3 epochs; Predictor serves 8 rows."""
    from multimodal_eeg_fmri_tpu_torch import (
        MultimodalEndToEnd,
        Predictor,
        init_weights,
        make_fit_fn,
    )
    from multimodal_eeg_fmri_tpu_torch.data.nifti import volumes_to_roi_features
    from multimodal_eeg_fmri_tpu_torch.data.raw import raw_recordings_to_dataset
    from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment

    n = COHORT + VAL_ROWS
    r = np.random.default_rng(60)
    labels = np.arange(n) % 2
    alpha = np.sin(2 * np.pi * 10.0 * np.arange(RAW_T) / FS).astype(np.float32)
    raw = r.standard_normal((n, RAW_T, CHANNELS), dtype=np.float32)
    raw += (2.0 * labels)[:, None, None].astype(np.float32) * alpha[None, :, None]
    atlas = r.integers(0, N_ROIS + 1, BOLD_SHAPE[:3]).astype(np.int32)
    reset_all_launches()
    t0 = time.perf_counter()
    data = raw_recordings_to_dataset(raw, labels, device=dev)
    data["activation"] = np.stack([
        volumes_to_roi_features(r.standard_normal(BOLD_SHAPE, dtype=np.float32),
                                atlas, n_rois=N_ROIS, device=dev)
        for _ in range(n)])
    features_s = time.perf_counter() - t0
    data["connectivity"] = r.standard_normal((n, 64), dtype=np.float32)
    data["weight"] = np.ones(n, np.float32)
    train = {k: v[:COHORT] for k, v in data.items()}
    val = {k: v[COHORT:] for k, v in data.items()}
    print(f"features of {n} subjects in {features_s:.2f} s: "
          + ", ".join(f"{k} {v.shape}" for k, v in data.items()))

    model = init_weights(MultimodalEndToEnd(dropout=0.0, pw_channels=90,
                                            activation_features=2 * N_ROIS,
                                            device=dev),
                         torch.Generator().manual_seed(9))
    fit = make_fit_fn(model, cfg, eval_names=("val",),
                      augment=make_eeg_augment(), preprocess=zscore_fn)
    result = fit(0, train, {"val": val}, torch.ones(2, device=dev))
    torch.cuda.synchronize()
    history = {k: v.cpu().numpy() for k, v in result.history.items()}
    rows = {k: val[k] for k in ("erp", "pw", "conn", "activation",
                                "connectivity")}
    served = Predictor(model, BATCH, preprocess=zscore_fn,
                       return_probs=False)(**rows)
    torch.cuda.synchronize()
    launches = {"sosfilt": s1_launches(), **total_launches()}
    model.eval()
    with torch.no_grad():
        inputs = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        eager = model(**{**inputs, **zscore_fn(inputs)}).logits.cpu().numpy()
    d = float(np.abs(served - eager).max())
    print("history: " + ", ".join(f"{k}={np.array2string(v, precision=5)}"
                                  for k, v in history.items()))
    print(f"launches over the path {launches} (S1 2, flash 0 at T={EPOCH}); "
          f"served logits {served.shape} vs an eager forward max|d|={d:.3e} "
          f"(limit {LOGITS_ATOL:g})")
    if launches != {"sosfilt": 2, "flash_fwd": 0, "flash_bwd_dkv": 0,
                    "flash_bwd_dq": 0}:
        fail(f"the raw path launched {launches}")
    if not (all(np.all(np.isfinite(v)) and v.shape == (EPOCHS,)
                for v in history.values()) and d <= LOGITS_ATOL):
        fail("non-finite history, or served logits unlike the forward")
    return launches


def raw_in_step_phase(dev, card: str, zscore_fn, bench_step, bench_batch,
                      gen) -> dict:
    """bench.py's build_step(raw_eeg=True) on the port: featurize → z-score
    → augment_temporal → MultimodalEndToEnd(dropout=0.3) → CE → backward →
    clip 1.0 → AdamW 5e-5 / 1e-5 at B=8, T=250, C=18; timed in turns with
    the featurized step (bench.py's headline step)."""
    from multimodal_eeg_fmri_tpu_torch import (
        MultimodalEndToEnd,
        TrainConfig,
        init_weights,
    )
    from multimodal_eeg_fmri_tpu_torch.data.raw import make_raw_eeg_featurizer
    from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    featurize = make_raw_eeg_featurizer(fs=FS, epoch_len=T_SHORT, device=dev)
    model = init_weights(MultimodalEndToEnd(pw_channels=90, device=dev),
                         torch.Generator().manual_seed(3))
    step = TrainStep(model, TrainConfig(loss="ce"), augment=make_eeg_augment())
    r = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "raw": r.standard_normal((BATCH, T_SHORT, CHANNELS), dtype=np.float32),
        "activation": r.standard_normal((BATCH, 90), dtype=np.float32),
        "connectivity": r.standard_normal((BATCH, 64), dtype=np.float32),
        "label": r.integers(0, 2, BATCH)}.items()}

    def raw_step(b, cw):
        feats = featurize(b["raw"])
        derived = {**{k: v for k, v in b.items() if k != "raw"}, **feats,
                   **zscore_fn(feats)}
        return step(derived, cw, gen)

    reset_all_launches()
    loss = raw_step(batch, None).item()
    launches = {"sosfilt": s1_launches(), **total_launches()}
    print(f"raw-in-step B={BATCH} T={T_SHORT}: loss {loss:.6f}, launches "
          f"{launches} (S1 2, flash 0: the einsum route at T={T_SHORT})")
    if launches != {"sosfilt": 2, "flash_fwd": 0, "flash_bwd_dkv": 0,
                    "flash_bwd_dq": 0} or not math.isfinite(loss):
        fail("the raw-in-step train step misbehaved")
    raw_ms, feat_ms = in_turns(
        lambda: step_ms(raw_step, batch, None),
        lambda: step_ms(lambda b, cw: bench_step(b, cw, gen), bench_batch,
                        None))
    print(f"raw_in_step_train_ms {raw_ms:.3f}; the featurized step (bench.py's"
          f" headline) {feat_ms:.3f} ms, in turns {card}")
    profile_calls(lambda: raw_step(batch, None),
                  f"raw-in-step train step B={BATCH} T={T_SHORT}", card)
    return {"ms": raw_ms, "launches": launches["sosfilt"]}


def stream_phase(dev, card: str) -> dict:
    """The streaming featurizer with examples/stream_monitor.py's settings
    (250 Hz, 1-s epochs, 200-ms chunks, 18 channels) over a 60-s session
    with an alpha burst in its second half: stream_session once, then the
    same steps by hand, timed. Gate 1: the carried band signals equal one
    causal sosfilt over the whole session; gate 2: the emitted features equal
    the offline causal oracle within tests/test_streaming.py's tolerances."""
    from multimodal_eeg_fmri_tpu_torch.data.raw import DEFAULT_BANDS
    from multimodal_eeg_fmri_tpu_torch.data.streaming import (
        make_streaming_featurizer,
        stream_session,
    )
    from multimodal_eeg_fmri_tpu_torch.ops import signal as S

    r = np.random.default_rng(70)
    t = np.arange(STREAM_SECONDS * int(FS)) / FS
    raw_np = r.standard_normal((len(t), CHANNELS)).astype(np.float32)
    burst = (t > STREAM_SECONDS / 2).astype(np.float32)
    raw_np += (2.0 * burst * np.sin(2 * np.pi * 10.0 * t))[:, None].astype(
        np.float32)
    raw = torch.from_numpy(raw_np).to(dev)
    init, step = make_streaming_featurizer(fs=FS, epoch_len=EPOCH,
                                           chunk_len=STREAM_CHUNK, device=dev)
    n_chunks = len(t) // STREAM_CHUNK
    reset_all_launches()
    outs = stream_session(raw, STREAM_CHUNK, init, step)
    torch.cuda.synchronize()
    launches = s1_launches()
    print(f"stream_session {len(t)} samples in {n_chunks} chunks: S1 "
          f"launches {launches} (1 per step, all 5 bands), flash "
          f"{total_launches()}; {int(outs['ready'].sum())} epochs")
    if launches != n_chunks or any(total_launches().values()):
        fail("the stream did not launch S1 once per step")

    state, bands = init(CHANNELS), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, len(t), STREAM_CHUNK):
        state, _ = step(state, raw[k:k + STREAM_CHUNK])
        bands.append(state.buf_band[:, -STREAM_CHUNK:])
    torch.cuda.synchronize()
    chunks_per_s = n_chunks / (time.perf_counter() - t0)
    coeffs = S.sos_coefficients(np.stack(
        [S.butter_bandpass_sos(lo, hi, FS, 4)[0]
         for lo, hi in DEFAULT_BANDS.values()]))

    def one_pass(chunk):     # each band over the whole session, one S1 call
        return torch.stack([S.sosfilt_cuda(coeffs[g:g + 1], raw, chunk=chunk)
                            for g in range(len(coeffs))])

    # the stream runs the sequential schedule, so its oracle does too
    one_shot = one_pass(len(t))
    carried = torch.cat(bands, dim=1)
    d1 = (carried - one_shot).abs().max().item()
    peak = one_shot.abs().max().item()
    print(f"gate 1: carried band signals vs one causal sosfilt per band "
          f"(sequential schedule): max|d|={d1:.3e} (limit 1e-5 · {peak:.3e})")
    if d1 > 1e-5 * peak:
        fail("the stream's carried filter state is not invisible")
    y64 = S.sosfilt_plain(coeffs, raw.repeat(1, len(coeffs)).double())[0]
    y64 = y64.view(len(t), len(coeffs), CHANNELS).transpose(0, 1)
    L = S.sosfilt_schedule(len(t), CHANNELS, 1, coeffs.shape[1])
    print(f"one pass per band against the f64 recurrence, max|d|: sequential "
          f"{(one_shot - y64).abs().max().item():.3e}, rule's schedule "
          f"(L={L}) {(one_pass(None) - y64).abs().max().item():.3e}, at "
          f"max|y|={y64.abs().max().item():.3e}")

    freqs = S.rfft_freqs(128, FS)
    alpha = one_shot[list(DEFAULT_BANDS).index("alpha")]
    tols = {"erp": (1e-6, 0.0), "pw": (2e-4, 1e-5), "conn": (2e-3, 2e-4)}
    worst, within = dict.fromkeys(tols, 0.0), True
    for e, k in enumerate(torch.nonzero(outs["ready"])[:, 0].tolist()):
        epoch = raw[e * EPOCH:(e + 1) * EPOCH]
        bp = S.band_power(S.spectrogram_power(epoch.T[None], 128, 64), freqs,
                          DEFAULT_BANDS)
        oracle = {"erp": epoch, "pw": bp[0].reshape(-1, bp.shape[-1]).T,
                  "conn": S.connectivity_features(
                      alpha[e * EPOCH:(e + 1) * EPOCH][None])}
        for key, want in oracle.items():
            rtol, atol = tols[key]
            diff = (outs[key][k] - want).abs()
            worst[key] = max(worst[key], diff.max().item())
            within &= bool((diff <= atol + rtol * want.abs()).all())
    print("gate 2: emitted features vs the offline causal oracle, max|d|: "
          + ", ".join(f"{k} {v:.3e} (rtol, atol {tols[k]})"
                      for k, v in worst.items())
          + f"; every element within: {within}")
    if not within:
        fail("the stream's features disagree with the offline oracle")
    print(f"stream: {chunks_per_s:.1f} chunks/s ({n_chunks} steps by hand, "
          f"{STREAM_CHUNK / FS * 1e3:.0f} ms of signal each) {card}")
    chunk = raw[:STREAM_CHUNK]
    profile_calls(lambda: step(state, chunk), "one stream step", card, n=20)
    return {"launches_per_step": launches // n_chunks,
            "chunks_per_sec": chunks_per_s}


# --- the cross-validation slice: train/cv.py on the card ---------------------

CV_EEG_N, CV_FMRI_N = 66, 32      # the cohorts of the JAX package's defaults
CV_EPOCHS, CV_FMRI_EPOCHS, CV_LOSO_EPOCHS, CV_SEEDS = 3, 5, 2, 4
CV_ATOL = 1e-4                    # a whole fit, route against route
REPORT_ATOL = 1e-5                # the clinical report, card against CPU
EEG_KEYS, FMRI_KEYS = ("erp", "pw", "conn"), ("activation", "connectivity")
# SHA-256 of the splits of cv_protocols (splits_sha256), as the JAX
# package's sklearn splits give them (tests/test_torch_port_splits.py)
CV_SPLITS_SHA256 = ("9549025f0f1da44501e003c62bb897373a3e9b8d76f923c509705"
                    "0f301cd086d")


def splits_sha256(protocols: list) -> str:
    """SHA-256 over every split of every protocol in order: each split's
    fold number and its train, val and test indices as little-endian int64,
    each array preceded by its length. Any object with ``train``, ``val``,
    ``test`` and ``fold`` (the JAX package's ``Split`` too) hashes alike."""
    h = hashlib.sha256()
    for splits in protocols:
        h.update(len(splits).to_bytes(8, "little"))
        for sp in splits:
            h.update(int(sp.fold).to_bytes(8, "little"))
            for idx in (sp.train, sp.val, sp.test):
                a = np.asarray(idx, dtype="<i8")
                h.update(len(a).to_bytes(8, "little"))
                h.update(a.tobytes())
    return h.hexdigest()


def cv_protocols(cfg) -> list:
    """The splits of the three front-ends on the cv phase's cohorts:
    eeg_kfold_splits (66 subjects), fmri_kfold_splits and loso_splits (32)."""
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
        synthetic_fmri,
    )
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        eeg_kfold_splits,
        fmri_kfold_splits,
        loso_splits,
    )

    eeg = synthetic_eeg_trimodal(n_subjects=CV_EEG_N)
    fmri = synthetic_fmri(n_subjects=CV_FMRI_N)
    return [eeg_kfold_splits(eeg, cfg), fmri_kfold_splits(fmri, cfg),
            loso_splits(fmri, cfg)]


def eeg_model(e, dropout: float, device):
    """TriModalFusionNetV4 at the widths of the EEGConfig ``e``."""
    from multimodal_eeg_fmri_tpu_torch.models.eeg import TriModalFusionNetV4

    return TriModalFusionNetV4(
        hidden_dim=e.hidden_dim, num_classes=e.num_classes, dropout=dropout,
        num_transformer_layers=e.num_transformer_layers,
        num_heads=e.num_heads, erp_channels=e.erp_channels,
        pw_channels=e.pw_channels, conn_features=e.conn_features,
        device=device)


def cv_fold(model, fit_fn, stacks, i: int, seed: int, task="classification"):
    """Fold ``i`` of a run by hand, as ``run_cv`` trains it: fresh weights
    from the fold's streams, ``fit_fn`` on the fold's slices of
    ``build_fold_arrays``'s ``stacks``, the best state evaluated on the
    fold's test set. Returns (FitResult, test metrics, test probs)."""
    from multimodal_eeg_fmri_tpu_torch.train.cv import fold_rngs, start_fold
    from multimodal_eeg_fmri_tpu_torch.train.evaluate import evaluate_dataset

    train, evals, cw = stacks
    rngs = fold_rngs(seed, next(model.parameters()).device)
    start_fold(model, rngs)

    def fold(stack):
        return {k: v[i] for k, v in stack.items()}

    res = fit_fn(rngs.shuffle, fold(train),
                 {name: fold(s) for name, s in evals.items()}, cw[i])
    metrics, out = evaluate_dataset(model, res.params, res.batch_stats,
                                    fold(evals["test"]), task)
    return res, metrics, torch.softmax(out.logits.float(), dim=-1)


def flash_layers(model, data: dict) -> int:
    """K1 launches of one eval forward of ``model`` on two rows of ``data``:
    the attention layers that take the kernels at this length."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        reset_kernel_launches,
    )
    from multimodal_eeg_fmri_tpu_torch.train.evaluate import apply_model

    reset_kernel_launches()
    apply_model(model, None, None, {k: v[:2] for k, v in data.items()})
    return total_launches()["flash_fwd"]


def cv_expected_launches(layers: int, train_rows: int, batch: int,
                         epochs: int, folds: int, eval_sets: int = 2) -> dict:
    """K1-K3 launches of a ``run_cv`` whose folds pad to ``train_rows``:
    per fold, each of ``layers`` flash layers runs K1 in every train step
    and every per-epoch evaluation, plus the final test evaluation, and K2
    and K3 in every train step."""
    steps = train_rows // min(batch, train_rows)
    return {"flash_fwd": folds * layers * ((steps + eval_sets) * epochs + 1),
            "flash_bwd_dkv": folds * layers * steps * epochs,
            "flash_bwd_dq": folds * layers * steps * epochs}


def cv_finite(result, what: str) -> None:
    """Gate d for one run: finite histories, fold metrics and outputs."""
    arrays = {**{f"history {k}": v for k, v in result.history.items()},
              **{f"metric {k}": v for k, v in result.fold_metrics.items()},
              "test probs": result.test_probs}
    bad = [k for k, v in arrays.items() if not np.all(np.isfinite(v))]
    if bad:
        fail(f"{what}: non-finite {bad}")


def cv_clinical(result, what: str) -> dict:
    """clinical_report of a run on the card, held against the same report
    on the CPU within REPORT_ATOL, gate d on it, and its summary printed."""
    from multimodal_eeg_fmri_tpu_torch.report.clinical import clinical_report

    report = clinical_report(result)
    per = report["per_fold"]
    on_cpu = clinical_report(result, device="cpu")["per_fold"]
    gap = max(float(np.max(np.abs(per[k] - on_cpu[k]))) for k in per)
    print(f"{what}: clinical_report card vs CPU max|d|={gap:.3e} "
          f"(limit {REPORT_ATOL:g})")
    if not gap <= REPORT_ATOL:
        fail(f"{what}: clinical report on the card disagrees with the CPU")
    cov = per["conformal_coverage"]
    if not all(np.all(np.isfinite(v)) for v in per.values()):
        fail(f"{what}: non-finite clinical values")
    if not np.all((cov >= 0) & (cov <= 1)):
        fail(f"{what}: conformal coverage outside [0, 1]: {cov}")
    print(f"{what}: clinical_report (alpha {report['alpha']}): "
          + ", ".join(f"{k} {m:.4f} ± {sd:.4f}"
                      for k, (m, sd) in report["summary"].items()))
    return report


def print_cv(result, seconds: float, what: str, card: str) -> None:
    print(f"{what}: {result.n_folds} folds in {seconds:.2f} s, "
          f"{seconds / result.n_folds:.3f} s per fold {card}; "
          + ", ".join(f"{k} {m:.4f} ± {sd:.4f}"
                      for k, (m, sd) in result.summary.items())
          + f"; best epochs {result.best_epochs.tolist()}")


def timed(fn):
    """(fn(), seconds), the clock stopped after a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cv_eeg_kfold_phase(dev, card: str) -> dict:
    """cv-eeg-kfold-T512: TriModalFusionNetV4 at EEGConfig's widths with
    dropout 0 through ``run_cv`` over eeg_kfold_splits, T=512 (all four
    temporal self-attention layers on K1-K3); launch counts, gate a (run_cv
    against a hand loop, bit for bit), gate b (fold 0 on the three routes),
    the clinical report and fold 0's busy share."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        EEGConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        build_fold_arrays,
        eeg_kfold_splits,
        fold_seeds,
        run_cv,
    )
    from multimodal_eeg_fmri_tpu_torch.train.fit import make_fit_fn

    data = synthetic_eeg_trimodal(n_subjects=CV_EEG_N, time_steps=T_SERVE)
    cfg = TrainConfig(batch_size=BATCH, num_epochs=CV_EPOCHS,
                      loss="weighted_ce", selection="val")
    splits = eeg_kfold_splits(data, cfg)
    stacks = build_fold_arrays(data, splits, "scalar", EEG_KEYS)
    rows = stacks[0]["label"].shape[1]
    real = stacks[0]["weight"].sum(axis=1).astype(int).tolist()
    model = eeg_model(EEGConfig(), 0.0, dev)
    layers = flash_layers(model, {k: v[0] for k, v in stacks[0].items()})
    expected = cv_expected_launches(layers, rows, BATCH, CV_EPOCHS,
                                    len(splits))
    steps = rows // BATCH
    print(f"{len(splits)} folds of {rows} padded train rows (real "
          f"{real}), batch {BATCH}: {steps} steps an epoch, "
          f"{steps * CV_EPOCHS} a fold; {layers} flash layers a forward")

    what = f"cv-eeg-kfold-T{T_SERVE}"
    reset_all_launches()
    result, seconds = timed(lambda: run_cv(model, cfg, data, splits,
                                           normalize_keys=EEG_KEYS))
    launches = total_launches()
    print_cv(result, seconds, what, card)
    print(f"launches {launches} (expected {expected}, from the fold "
          "length, the steps and the evaluations)")
    if launches != expected:
        fail(f"{what} launched {launches}, expected {expected}")
    cv_finite(result, what)
    cv_clinical(result, what)

    seeds = fold_seeds(cfg.seed, len(splits))
    fit_fn = make_fit_fn(model, cfg, eval_names=("val", "test"))
    with deterministic():
        det, det_s = timed(lambda: run_cv(model, cfg, data, splits,
                                          normalize_keys=EEG_KEYS))
        gaps, fold_s = [], []
        for i, seed in enumerate(seeds):
            (res, metrics, probs), s = timed(
                lambda: cv_fold(model, fit_fn, stacks, i, seed))
            fold_s.append(s)
            pick = lambda d: {k: v[i] for k, v in d.items()}
            gaps.append(max(
                max_diff(pick(det.params), res.params),
                max_diff(pick(det.batch_stats), res.batch_stats),
                max_diff({k: torch.as_tensor(v) for k, v in
                          pick(det.history).items()}, res.history),
                max_diff({k: torch.as_tensor(v) for k, v in
                          pick(det.fold_metrics).items()}, metrics),
                max_diff({"p": torch.as_tensor(det.test_probs[i])},
                         {"p": probs})))
    print(f"gate a: run_cv vs a hand loop of make_fit_fn over the same "
          f"fold arrays, generators and initial weights, under "
          f"torch.use_deterministic_algorithms(True): max|d| per fold "
          f"(params, statistics, history, metrics, test probs) {gaps} "
          f"(limit 0); {det_s:.2f} s for run_cv, "
          f"{[round(s, 3) for s in fold_s]} s per fold by hand {card}")
    if any(gaps):
        fail("gate a: run_cv is not bit-identical to the hand loop")

    busy = profile_calls(lambda: cv_fold(model, fit_fn, stacks, 0, seeds[0]),
                         f"fold 0's fit ({steps * CV_EPOCHS} steps, "
                         f"{2 * CV_EPOCHS + 1} evaluations)", card, n=1)

    # gate b: fold 0, the whole padded fold in one batch, three routes
    whole = dataclasses.replace(cfg, batch_size=rows)
    routes = {}
    base = eeg_model(EEGConfig(), 0.0, "cpu")
    for m in base.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    for name, m in (("kernel", copy.deepcopy(base).to(dev)),
                    ("einsum", einsum_route(copy.deepcopy(base).to(dev))),
                    ("cpu", copy.deepcopy(base))):
        reset_all_launches()
        (res, _, probs), s = timed(lambda: cv_fold(
            m, make_fit_fn(m, whole, eval_names=("val", "test")), stacks, 0,
            seeds[0]))
        routes[name] = (res.best_metric.item(), probs.cpu(),
                        total_launches(), s)
    kernel_metric, kernel_probs, kernel_launches, _ = routes["kernel"]
    whole_expected = cv_expected_launches(layers, rows, rows, CV_EPOCHS, 1)
    if (kernel_launches != whole_expected
            or any(routes["einsum"][2].values())):
        fail(f"gate b: the kernel route launched {kernel_launches} "
             f"(expected {whole_expected}), the einsum route "
             f"{routes['einsum'][2]} (expected none)")
    for other in ("einsum", "cpu"):
        metric, probs, _, s = routes[other]
        d_probs = (kernel_probs - probs).abs().max().item()
        d_metric = abs(kernel_metric - metric)
        print(f"gate b: fold 0, batch {rows} (one step an epoch), kernel "
              f"route vs {other}: test probs max|d| {d_probs:.3e}, best "
              f"metric {kernel_metric:.6f} vs {metric:.6f} (limit "
              f"{CV_ATOL:g}); {routes['kernel'][3]:.2f} s vs {s:.2f} s")
        if not (d_probs <= CV_ATOL and d_metric <= CV_ATOL):
            fail(f"gate b: the kernel route's fold 0 disagrees with the "
                 f"{other} route")
    return {"launches": launches, "seconds": seconds,
            "seconds_per_fold": seconds / len(splits),
            "steps_per_fold": steps * CV_EPOCHS, "busy": busy}


def cv_eeg_pipeline_phase(dev, card: str) -> dict:
    """cv-eeg-pipeline-T250: the JAX pipeline's own settings, EEGConfig()
    (T=250, dropout 0.3) with its augmentation, 1 epoch, 5 folds: the
    einsum route, no kernel launch."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        EEGConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        eeg_kfold_splits,
        run_cv,
    )

    e = EEGConfig()
    model = eeg_model(e, e.dropout, dev)
    data = synthetic_eeg_trimodal(n_subjects=CV_EEG_N,
                                  time_steps=e.time_steps)
    cfg = TrainConfig(batch_size=BATCH, num_epochs=1, selection="val")
    augment = make_eeg_augment(noise_std=e.augment_noise_std,
                               channel_dropout=e.augment_channel_dropout,
                               prob=e.augment_prob)
    splits = eeg_kfold_splits(data, cfg, n_splits=e.n_splits)
    reset_all_launches()
    result, seconds = timed(lambda: run_cv(
        model, cfg, data, splits, augment=augment, normalize_keys=EEG_KEYS))
    launches = total_launches()
    what = f"cv-eeg-pipeline-T{e.time_steps}"
    print_cv(result, seconds, what, card)
    if any(launches.values()):
        fail(f"{what} launched {launches}; it takes the einsum route")
    print(f"launches {launches}: the einsum route, as the auto rule says")
    cv_finite(result, what)
    return {"seconds": seconds, "seconds_per_fold": seconds / len(splits)}


def cv_fmri_phase(dev, card: str) -> dict:
    """cv-fmri: FMRIFusionNet at FMRIConfig's widths over 32 subjects:
    5-fold with per-feature normalization, LOSO with subject votes and the
    pooled clinical report, and a seed sweep."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        FMRIConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data.normalize import (
        feature_standardize,
    )
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import synthetic_fmri
    from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
    from multimodal_eeg_fmri_tpu_torch.report.clinical import (
        pooled_clinical_report,
    )
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        fmri_kfold_splits,
        loso_splits,
        run_cv,
        run_seed_sweep,
        subject_level_votes,
    )

    f = FMRIConfig()
    data = synthetic_fmri(n_subjects=CV_FMRI_N)
    data.pop("reg_label")
    model = FMRIFusionNet(hidden_dim=f.hidden_dim, num_classes=f.num_classes,
                          dropout=f.dropout,
                          activation_features=data["activation"].shape[1],
                          connectivity_features=data["connectivity"].shape[1],
                          device=dev)
    cfg = TrainConfig(batch_size=BATCH, num_epochs=CV_FMRI_EPOCHS,
                      selection="val")
    out = {}
    kfold, seconds = timed(lambda: run_cv(
        model, cfg, data, fmri_kfold_splits(data, cfg, n_splits=f.n_splits),
        normalize="feature", normalize_keys=FMRI_KEYS))
    print_cv(kfold, seconds, f"fmri k-fold, {CV_FMRI_EPOCHS} epochs", card)
    cv_finite(kfold, "cv-fmri k-fold")
    cv_clinical(kfold, "cv-fmri k-fold")
    out["kfold_seconds"] = seconds

    loso, seconds = timed(lambda: run_cv(
        model, dataclasses.replace(cfg, num_epochs=CV_LOSO_EPOCHS), data,
        loso_splits(data, cfg), normalize="feature",
        normalize_keys=FMRI_KEYS))
    votes = subject_level_votes(loso)
    print_cv(loso, seconds, f"fmri LOSO, {CV_LOSO_EPOCHS} epochs", card)
    cv_finite(loso, "cv-fmri LOSO")
    truth = dict(zip(data["subject"].tolist(), data["label"].tolist()))
    if sorted(votes) != sorted(truth):
        fail(f"LOSO voted for subjects {sorted(votes)}")
    real = loso.test_weight > 0
    pooled = pooled_clinical_report(loso.test_probs[real],
                                    loso.test_labels[real])
    pooled_cpu = pooled_clinical_report(loso.test_probs[real],
                                        loso.test_labels[real], device="cpu")
    gap = max(abs(pooled[k] - pooled_cpu[k]) for k in pooled)
    print(f"LOSO pooled clinical report card vs CPU max|d|={gap:.3e} "
          f"(limit {REPORT_ATOL:g})")
    if not gap <= REPORT_ATOL:
        fail("cv-fmri LOSO: pooled clinical report on the card disagrees "
             "with the CPU")
    print(f"LOSO subject votes: {sum(votes[s] == truth[s] for s in votes)} "
          f"of {len(votes)} right; pooled clinical report "
          + ", ".join(f"{k} {v:.4f}" for k, v in pooled.items()))
    if not (all(math.isfinite(v) for v in pooled.values())
            and 0 <= pooled["conformal_coverage"] <= 1):
        fail(f"cv-fmri LOSO: pooled clinical report {pooled}")
    out["loso_seconds"] = seconds

    n_train = CV_FMRI_N * 3 // 4
    normed = feature_standardize(
        {**data, "weight": np.ones(CV_FMRI_N, np.float32)},
        np.arange(n_train), FMRI_KEYS)
    train = {k: v[:n_train] for k, v in normed.items()}
    val = {k: v[n_train:] for k, v in normed.items()}
    sweep, seconds = timed(lambda: run_seed_sweep(
        model, cfg, train, {"val": val}, CV_SEEDS))
    lo, hi = sweep["ci95"]
    print(f"seed sweep, {CV_SEEDS} seeds: best val f1 "
          f"{np.array2string(sweep['best_metric'], precision=4)}, mean "
          f"{sweep['mean']:.4f}, std {sweep['std']:.4f}, 95% CI "
          f"[{lo:.4f}, {hi:.4f}] in {seconds:.2f} s {card}")
    if not (np.all(np.isfinite(sweep["best_metric"])) and lo <= sweep["mean"]
            <= hi and all(np.all(np.isfinite(v))
                          for v in sweep["history"].values())):
        fail("seed sweep: non-finite values, or a CI that misses its mean")
    out["sweep_seconds"] = seconds
    return out


def cv_phase(dev, card: str) -> dict:
    """The cv phase: gate c, then the three CV configurations."""
    from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig

    digest = splits_sha256(cv_protocols(TrainConfig()))
    print(f"gate c: SHA-256 of the splits of eeg_kfold_splits "
          f"({CV_EEG_N} subjects), fmri_kfold_splits and loso_splits "
          f"({CV_FMRI_N}): {digest} (pinned: {CV_SPLITS_SHA256})")
    if digest != CV_SPLITS_SHA256:
        fail("gate c: the splits differ from the JAX package's")
    phase(f"cv-eeg-kfold-T{T_SERVE}: TriModalFusionNetV4 at EEGConfig's "
          f"widths, dropout 0, {CV_EEG_N} subjects, 5 folds, {CV_EPOCHS} "
          "epochs")
    eeg = cv_eeg_kfold_phase(dev, card)
    phase(f"cv-eeg-pipeline-T{T_SHORT}: EEGConfig() with its augmentation, "
          "1 epoch, 5 folds")
    pipeline = cv_eeg_pipeline_phase(dev, card)
    phase(f"cv-fmri: FMRIFusionNet at FMRIConfig's widths, {CV_FMRI_N} "
          f"subjects: 5-fold, LOSO, {CV_SEEDS}-seed sweep")
    fmri = cv_fmri_phase(dev, card)
    print(json.dumps({"cv": {"eeg_kfold_T512": {
        k: v for k, v in eeg.items() if k != "launches"},
        "eeg_pipeline_T250": pipeline, "fmri": fmri, "device": card}}))
    return eeg


def main() -> None:
    # deterministic cuBLAS for the resume phase; read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # bf16 GEMMs sum in f32, as XLA's bf16 dots do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)

    from multimodal_eeg_fmri_tpu_torch import (
        MultimodalEndToEnd,
        Predictor,
        TrainConfig,
        Trainer,
        fit_resumable,
        init_weights,
        make_fit_fn,
    )
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion
    from multimodal_eeg_fmri_tpu_torch.models.layers import BatchNorm
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
    from multimodal_eeg_fmri_tpu_torch.train.resilient import latest_chunk

    phase("build: registers, spills and tensor-core instructions")
    build_and_inspect(_kernels)

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

    phase(f"fault C5: K2 and K3 in the bf16-operand mode at "
          f"{C5_CASE}, over {C5_SEEDS} seeds of g_lse")
    c5_sweep(dev)

    phase("kernel vs plain version in bf16 storage, f32 operands: K1, K2 "
          "and K3 at the main path's shapes")
    worst_bf16 = dict.fromkeys(worst, 0.0)
    for B, H, T, d in SLICE_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, d, device=dev,
                                  generator=gen).bfloat16() for _ in range(4))
        out_k, lse_k = flash_forward_cuda(q, k, v)
        out_p, lse_p = flash_forward_plain(q, k, v)
        delta = flash_delta(out_k, g)
        dk_k, dv_k = flash_bwd_dkv_cuda(q, k, v, g, lse_k, delta)
        dq_k = flash_bwd_dq_cuda(q, k, v, g, lse_k, delta)
        dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse_k, delta)
        dq_p = flash_bwd_dq_plain(q, k, v, g, lse_k, delta)
        torch.cuda.synchronize()
        if not all(t.dtype == torch.bfloat16
                   for t in (out_k, dk_k, dv_k, dq_k)):
            fail("a bf16-storage kernel did not write bf16")
        d_out = (out_k.float() - out_p.float()).abs().max().item()
        d_lse = (lse_k - lse_p).abs().max().item()
        e_dkv = max((dk_k.float() - dk_p.float()).abs().max().item(),
                    (dv_k.float() - dv_p.float()).abs().max().item())
        e_dq = (dq_k.float() - dq_p.float()).abs().max().item()
        lim_dkv = grad_limit_bf16(max(dk_p.float().abs().max().item(),
                                      dv_p.float().abs().max().item()))
        lim_dq = grad_limit_bf16(dq_p.float().abs().max().item())
        print(f"(B,H,T,D)=({B},{H},{T},{d}) bf16 storage: max|dO|={d_out:.3e} "
              f"(limit {BF16_ATOL:g}), max|dlse|={d_lse:.3e} (limit "
              f"{LSE_ATOL:g}); max|d(dK,dV)|={e_dkv:.3e} (limit "
              f"{lim_dkv:.3e}), max|d(dQ)|={e_dq:.3e} (limit {lim_dq:.3e})")
        if not (d_out <= BF16_ATOL and d_lse <= LSE_ATOL and e_dkv <= lim_dkv
                and e_dq <= lim_dq):
            fail(f"a bf16-storage kernel disagrees with its plain version at "
                 f"{(B, H, T, d)}")
        for name, err in (("flash_fwd", max(d_out, d_lse)),
                          ("flash_bwd_dkv", e_dkv), ("flash_bwd_dq", e_dq)):
            worst_bf16[name] = max(worst_bf16[name], err)

    phase("kernel vs plain version: S1, the biquad cascade (sosfilt), at "
          "the shapes of raw-featurize, raw-in-step, raw-e2e and stream")
    s1 = s1_phase(dev, card)

    phase("autograd through K1+K2+K3 vs through the einsum reference")
    B, H, T, d = SLICE_SHAPES[1]
    x = torch.randn(3, B, T, H, d, device=dev, generator=gen,
                    requires_grad=True)
    q, k, v = (t.transpose(1, 2) for t in x)     # the model's strided layout
    g = torch.randn(B, H, T, d, device=dev, generator=gen)
    g_lse = torch.randn(B, H, T, device=dev, generator=gen)
    scale = 1.0 / math.sqrt(d)
    before = total_launches()
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
    after = total_launches()
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
    serve_launches = total_launches()
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

    before = total_launches()
    short = predictor(**request(BATCH, T_SHORT, seed=20))
    torch.cuda.synchronize()
    if total_launches() != before or not np.all(np.isfinite(short)):
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
    train_launches = total_launches()
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

    phase(f"mixed-precision training path: compute_dtype='bfloat16', "
          f"MultimodalEndToEnd(dropout=0.0) defaults, {COHORT} subjects, "
          f"T={T_SERVE}, {EPOCHS} epochs")
    bf16_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    mp_model = init_weights(MultimodalEndToEnd(dropout=0.0, device=dev),
                            torch.Generator().manual_seed(1))
    mp_initial = {k: p.detach().clone()
                  for k, p in mp_model.named_parameters()}
    mp_fit = make_fit_fn(mp_model, bf16_cfg, eval_names=("val",),
                         augment=make_eeg_augment(), preprocess=zscore)
    reset_kernel_launches()
    t0 = time.perf_counter()
    mp_result = mp_fit(0, cohort, {"val": val}, class_weights)
    torch.cuda.synchronize()
    mp_s = time.perf_counter() - t0
    mp_launches = kernel_launches()
    # bf16 q/k/v in every train step, f32 in every evaluation
    mp_expected = {
        "flash_fwd": {"f32": 4 * EPOCHS, "bf16": 4 * steps},
        "flash_bwd_dkv": {"f32": 0, "bf16": 4 * steps},
        "flash_bwd_dq": {"f32": 0, "bf16": 4 * steps}}
    mp_history = {k: v.cpu().numpy() for k, v in mp_result.history.items()}
    print(f"bf16 fit: {steps} steps and {EPOCHS} evals in {mp_s:.2f} s; "
          f"launches by storage {mp_launches} (expected {mp_expected})")
    print("history: " + ", ".join(f"{k}={np.array2string(v, precision=5)}"
                                  for k, v in mp_history.items()))
    if mp_launches != mp_expected:
        fail(f"the bf16 fit launched {mp_launches}, expected {mp_expected}")
    if not all(np.all(np.isfinite(v)) and v.shape == (EPOCHS,)
               for v in mp_history.values()):
        fail("non-finite or short history in the bf16 fit")
    mp_moved = max((p.detach() - mp_initial[k]).abs().max().item()
                   for k, p in mp_model.named_parameters())
    master = [p.dtype for p in mp_model.parameters()] + [
        t.dtype for t in (*mp_result.params.values(),
                          *mp_result.carry.opt_state["exp_avg"].values())]
    stats = [b.dtype for m in mp_model.modules() if isinstance(m, BatchNorm)
             for b in (m.running_mean, m.running_var)]
    print(f"params moved by up to {mp_moved:.3e}; master params, AdamW state "
          f"and BatchNorm statistics {sorted({str(t) for t in master + stats})}")
    if not (mp_moved > 0 and set(master + stats) == {torch.float32}):
        fail("the bf16 fit did not move the params or left f32")

    phase("one bf16 train step: kernel route vs einsum route on the card, "
          "and vs the CPU path")
    bf_grads, bf_losses = {}, {}
    for name, m in (("kernel", copy.deepcopy(base)),
                    ("einsum", einsum_route(copy.deepcopy(base))),
                    ("cpu", copy.deepcopy(base).cpu())):
        step = TrainStep(m, bf16_cfg, preprocess=zscore)
        mdev = next(m.parameters()).device
        loss = step.loss({k: v.to(mdev) for k, v in batch.items()},
                         class_weights.to(mdev))
        loss.backward()
        bf_losses[name] = loss.item()
        bf_grads[name] = {k: p.grad.to(dev) for k, p in m.named_parameters()}

    def grad_gap(a, b) -> tuple:
        """(max|a − b| over every gradient, over the largest |b|; the
        tensor where it is largest). bf16 rounds each gradient to about 3
        significant digits, so a tensor's own scale is no yardstick: a
        scalar's near-zero gradient is all rounding."""
        g_max = max(g.abs().max().item() for g in b.values())
        return max(((a[k] - g).abs().max().item() / g_max, k)
                   for k, g in b.items())

    f32_gap = grad_gap(bf_grads["kernel"], grads["kernel"])
    print(f"bf16 kernel route vs the f32 kernel route: loss |d|="
          f"{abs(bf_losses['kernel'] - losses['kernel']):.3e}, gradients "
          f"max|d| / the largest gradient {f32_gap[0]:.3e} at {f32_gap[1]} "
          f"(the size of bf16 rounding)")
    for other in ("einsum", "cpu"):
        d_loss = abs(bf_losses["kernel"] - bf_losses[other])
        rel, worst_name = grad_gap(bf_grads["kernel"], bf_grads[other])
        print(f"bf16 kernel vs {other}: loss {bf_losses['kernel']:.7f} vs "
              f"{bf_losses[other]:.7f} (|d|={d_loss:.3e}, limit "
              f"{BF16_STEP_LOSS_ATOL:g}); gradients max|d| / the largest "
              f"gradient {rel:.3e} at {worst_name} (limit "
              f"{BF16_STEP_GRAD_RTOL:g})")
        if not (d_loss <= BF16_STEP_LOSS_ATOL and rel <= BF16_STEP_GRAD_RTOL):
            fail(f"the bf16 step on the kernel route disagrees with the "
                 f"{other} route")

    phase(f"gradient accumulation and EMA: grad_accum={ACCUM}, ema_decay="
          f"{EMA_DECAY}, T={T_SERVE}, {EPOCHS} epochs")
    ae_cfg = dataclasses.replace(cfg, grad_accum=ACCUM, ema_decay=EMA_DECAY)
    ae_model = init_weights(MultimodalEndToEnd(dropout=0.0, device=dev),
                            torch.Generator().manual_seed(1))
    ae_fit = make_fit_fn(ae_model, ae_cfg, eval_names=("val",),
                         augment=make_eeg_augment(), preprocess=zscore)
    reset_kernel_launches()
    ae_result = ae_fit(0, cohort, {"val": val}, class_weights)
    torch.cuda.synchronize()
    ae_launches = total_launches()
    ae_expected = {"flash_fwd": 4 * (ACCUM * steps + EPOCHS),
                   "flash_bwd_dkv": 4 * ACCUM * steps,
                   "flash_bwd_dq": 4 * ACCUM * steps}
    ae_history = {k: v.cpu().numpy() for k, v in ae_result.history.items()}
    ema_lag = max_diff(ae_result.carry.ema_params, ae_result.carry.params)
    print(f"launches {ae_launches} (expected {ae_expected}); train loss "
          f"{np.array2string(ae_history['train_loss'], precision=5)}; EMA "
          f"lags the params by up to {ema_lag:.3e}")
    if ae_launches != ae_expected:
        fail(f"grad_accum + EMA launched {ae_launches}, expected "
             f"{ae_expected}")
    if not (all(np.all(np.isfinite(v)) for v in ae_history.values())
            and ema_lag > 0):
        fail("non-finite history, or an EMA equal to the params")

    def fresh(seed):
        return init_weights(MultimodalEndToEnd(dropout=0.0, device=dev),
                            torch.Generator().manual_seed(seed))

    evals = {"val": val}
    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        phase("resumable training: fit_resumable, chunk_epochs=1, a crash in "
              "the third chunk, resume; torch.use_deterministic_algorithms"
              "(True)")
        torch.manual_seed(5)
        one = make_fit_fn(fresh(4), cfg, eval_names=("val",),
                          augment=make_eeg_augment(), preprocess=zscore)(
            0, cohort, evals, class_weights)
        ck = Path(tmp) / "chunks"
        torch.manual_seed(5)
        try:
            fit_resumable(fresh(4), cfg, 0, cohort, evals, ck, class_weights,
                          chunk_epochs=1, preprocess=zscore,
                          augment=crashing(make_eeg_augment(),
                                           2 * (COHORT // BATCH)))
        except InjectedCrash as e:
            print(f"chunks 0 and 1 written, then: {e}")
        else:
            fail("the injected crash did not happen")
        if latest_chunk(ck) != 1:
            fail(f"the last complete chunk is {latest_chunk(ck)}, not 1")
        torch.manual_seed(6)
        resumed = fit_resumable(fresh(6), cfg, 0, cohort, evals, ck,
                                class_weights, chunk_epochs=1,
                                preprocess=zscore, augment=make_eeg_augment())
        torch.cuda.synchronize()
        gaps = {
            "history": max_diff(resumed.history, one.history),
            "final params": max_diff(resumed.final_params, one.final_params),
            "best params": max_diff(resumed.params, one.params),
            "statistics": max_diff(resumed.final_batch_stats,
                                   one.final_batch_stats),
            "AdamW moments": max(max_diff(resumed.carry.opt_state[k],
                                          one.carry.opt_state[k])
                                 for k in ("exp_avg", "exp_avg_sq"))}
        print(f"resumed from chunk 1 vs one uninterrupted run, max|d|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + " (limit 0)")
        if any(gaps.values()):
            fail("the resumed run is not bit-identical to the uninterrupted "
                 "one")

        phase("Trainer: two epochs with evaluate, then a save_checkpoint / "
              "load_checkpoint round trip")
        t_cfg = dataclasses.replace(cfg, num_epochs=2, ema_decay=EMA_DECAY)
        torch.manual_seed(7)
        trainer = Trainer(fresh(7), t_cfg, augment=make_eeg_augment(),
                          generator=7)
        reset_kernel_launches()
        t_hist = trainer.fit(cohort, val, class_weights)
        torch.cuda.synchronize()
        t_launches = total_launches()
        t_steps = 2 * (COHORT // BATCH)
        t_expected = {"flash_fwd": 4 * (t_steps + 2),
                      "flash_bwd_dkv": 4 * t_steps,
                      "flash_bwd_dq": 4 * t_steps}
        t_metrics = trainer.evaluate(val)
        path = trainer.save_checkpoint(Path(tmp) / "trainer")
        restored = Trainer(fresh(8), t_cfg, augment=make_eeg_augment(),
                           generator=8)
        restored.load_checkpoint(path)
        c0, c1 = trainer._carry, restored._carry
        state_gap = max(
            max_diff(c1.params, c0.params),
            max_diff(c1.batch_stats, c0.batch_stats),
            max_diff(c1.ema_params, c0.ema_params),
            max_diff(restored.best_state[0], trainer.best_state[0]),
            *(max_diff(c1.opt_state[k], c0.opt_state[k])
              for k in ("exp_avg", "exp_avg_sq")))
        same = (torch.equal(c1.rng, c0.rng)
                and torch.equal(c1.torch_rng, c0.torch_rng)
                and restored.epoch == trainer.epoch
                and restored.history == trainer.history
                and restored.best_metric == trainer.best_metric)
        next_losses = (trainer.train_one_epoch(cohort, class_weights),
                       restored.train_one_epoch(cohort, class_weights))
        print(f"Trainer: train loss {t_hist['train_loss']}, val f1 "
              f"{t_hist['f1']}; launches {t_launches} (expected "
              f"{t_expected}); evaluate {t_metrics}; restored state max|d| "
              f"{state_gap:.3e}, counters and generators equal: {same}; "
              f"the next epoch's loss {next_losses[0]!r} vs "
              f"{next_losses[1]!r}")
        if t_launches != t_expected:
            fail(f"Trainer launched {t_launches}, expected {t_expected}")
        if not (np.all(np.isfinite(t_hist["train_loss"])) and same
                and state_gap == 0 and next_losses[0] == next_losses[1]):
            fail("the Trainer's checkpoint round trip did not restore its "
                 "state")

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
    if any(total_launches().values()) or not math.isfinite(loss):
        fail(f"T={T_SHORT} step launched {total_launches()} or gave loss "
             f"{loss}")
    print(f"T={T_SHORT}, dropout 0.3: loss {loss:.6f}, launches "
          f"{total_launches()} (the einsum route, as the auto rule says)")

    phase(f"raw-featurize: bench.py's featurizer, N={RAW_N}, T={RAW_T}, "
          f"C={CHANNELS}")
    featurized = raw_featurize_phase(dev, card)
    phase(f"fmri-roi: bench.py's BOLD run {BOLD_SHAPE}, {N_ROIS} ROIs")
    fmri_rates = fmri_roi_phase(dev, card)
    phase(f"raw-e2e: raw EEG and BOLD of {COHORT} + {VAL_ROWS} subjects → "
          f"features → make_fit_fn, {EPOCHS} epochs → Predictor")
    raw_path_launches = raw_e2e_phase(dev, cfg, zscore)
    phase(f"raw-in-step-T{T_SHORT}: bench.py's build_step(raw_eeg=True)")
    raw_step = raw_in_step_phase(dev, card, zscore, bench_step, bench_batch,
                                 gen)
    phase(f"stream: {STREAM_SECONDS} s at {FS:g} Hz in {STREAM_CHUNK}-sample "
          f"chunks, {CHANNELS} channels")
    stream = stream_phase(dev, card)
    print(json.dumps({"bench_extras": {
        "eeg_epochs_per_sec": featurized["eeg_epochs_per_sec"],
        "fmri_volumes_per_sec": fmri_rates["host"],
        "fmri_volumes_per_sec_device": fmri_rates["device"],
        "raw_in_step_train_ms": raw_step["ms"],
        "stream_chunks_per_sec": stream["chunks_per_sec"],
        "device": smi}}))

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
    timed["bf16"] = TrainStep(copy.deepcopy(base), bf16_cfg, preprocess=zscore)
    f32_ms, bf16_ms = in_turns(
        lambda: step_ms(timed["kernel"], batch, class_weights),
        lambda: step_ms(timed["bf16"], batch, class_weights))
    print(f"train step B={BATCH} T={T_SERVE} dropout 0, kernel route: f32 "
          f"{f32_ms:.3f} ms, bf16 mixed precision {bf16_ms:.3f} ms {card}")
    bench_ms = step_ms(lambda b, cw: bench_step(b, cw, gen), bench_batch, None)
    print(f"train step B={BATCH} T={T_SHORT} dropout 0.3 (bench.py's step): "
          f"{bench_ms:.3f} ms {card}")
    profile_calls(lambda: timed["kernel"](batch, class_weights),
                  f"5 train steps B={BATCH} T={T_SERVE} kernel route", card)

    from torch.nn.functional import scaled_dot_product_attention as sdpa

    per_step = {(k, storage): {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                               "bound_ms": 0.0, "library_ms": 0.0,
                               "library_device_ms": 0.0, "ops": 0.0}
                for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
                for storage in ("f32", "bf16")}
    for (B, H, T, d), storage in [(s, st) for st in ("f32", "bf16")
                                  for s in SLICE_SHAPES]:
        q, k, v, g = (torch.randn(B, H, T, d, device=dev, generator=gen).to(
            torch.float32 if storage == "f32" else torch.bfloat16)
            for _ in range(4))
        out, lse = flash_forward_cuda(q, k, v)
        delta = flash_delta(out, g)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl)

        def lib_fwd():
            return sdpa(q, k, v)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                       retain_graph=True)

        lib_times = {f: (cuda_ms(f), device_ms(f))
                     for f in (lib_fwd, lib_bwd)}
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
        for name, (kern, plain, lib_fn) in pairs.items():
            ms, plain_ms = in_turns(lambda: cuda_ms(kern),
                                    lambda: cuda_ms(plain))
            dev_ms = device_ms(kern)
            lib_ms, lib_dev_ms = lib_times[lib_fn]
            b_ms, by = bound_ms(name, B, H, T, T, d, storage)
            # two layers of each shape per train step
            for key, val in (("ms", ms), ("device_ms", dev_ms),
                             ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms),
                             ("library_device_ms", lib_dev_ms),
                             ("ops", by == "operations")):
                per_step[name, storage][key] += 2 * val
            print(f"{name} (B,H,T,D)=({B},{H},{T},{d}) {storage} storage: "
                  f"kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}), library (SDPA "
                  f"{'forward' if name == 'flash_fwd' else 'backward, dQ+dK+dV'}"
                  f") {lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms) per call "
                  f"{card}")

    replaces = {"flash_fwd": "multimodal_eeg_fmri_tpu/ops/attention.py:63",
                "flash_bwd_dkv": "multimodal_eeg_fmri_tpu/ops/attention.py:121",
                "flash_bwd_dq": "multimodal_eeg_fmri_tpu/ops/attention.py:173"}
    source = {"flash_fwd": "multimodal_eeg_fmri_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd_dkv": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dq": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu"}
    for storage in ("f32", "bf16"):
        print(f"per train step, {storage} storage (2 layers at T=256, 2 at "
              f"T=512): " + "; ".join(
                  f"{k} {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms "
                  f"(bound {v['bound_ms']:.4f})"
                  for (k, st), v in per_step.items() if st == storage))

    def timings(t: dict) -> dict:
        return {"ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops"] else "bytes",
                "library_ms": t["library_ms"],
                "library_device_ms": t["library_device_ms"]}

    phase(f"cv: train/cv.py on the card {card}")
    cv = cv_phase(dev, card)

    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source[name],
        "replaces": replaces[name],
        "launches": train_launches[name],
        # each path's launches: the training path's, and run_cv's
        "launches_by_path": {"train-e2e-T512": train_launches[name],
                             "cv-eeg-kfold-T512": cv["launches"][name]},
        "max_abs_err": worst[name],
        **timings(per_step[name, "f32"]),
        # the mixed-precision fit's launches by storage, and the
        # bf16-storage instance's error and times
        "launches_bf16_fit": mp_launches[name],
        "bf16_storage": {"max_abs_err": worst_bf16[name],
                         **timings(per_step[name, "bf16"])},
    } for name in names] + [{
        "name": "sosfilt",
        "route": "cuda",
        "source": S1_SOURCE,
        "replaces": S1_REPLACES,
        # the raw-e2e path's launches; then each path's
        "launches": raw_path_launches["sosfilt"],
        "launches_by_path": {"raw-featurize": featurized["launches"],
                             "raw-e2e": raw_path_launches["sosfilt"],
                             "raw-in-step, per step": raw_step["launches"],
                             "stream, per step": stream["launches_per_step"]},
        "max_abs_err": s1["max_abs_err"],
        # the featurizer's pass on the rule's schedule (chunk L), beside
        # the sequential schedule's times; then every main-path shape
        **{k: s1["featurizer pass"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape",
            "chunk", "device_kernels", "sequential_ms",
            "sequential_device_ms")},
        "library_ms": None,
        "stream_chunk": s1["stream chunk"],
        "by_shape": {k: v for k, v in s1.items()
                     if k not in ("max_abs_err", "bands")},
        "f64_errors_by_band": s1["bands"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
