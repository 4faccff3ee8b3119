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
The kernel-vs-plain phase also runs K1, K2 and K3 once at B·H = 65,600,
past the 65,535 blocks of the grid's y axis (B·H runs on its x axis).

Last, the bridge slice (the bridge phase: ``xai/``, ``train/bridge_flow.py``),
at the JAX package's default widths with only epoch counts cut: stage 1
trains TriModalFusionNetV4 (EEGConfig, dropout 0.3, 66 subjects at T=512)
and FMRIFusionNet (32 subjects) 3 epochs each with selection on the train
loss; ``extract_fused_features`` (one eval forward, K1 in the four temporal
layers) gives embeddings held to the einsum route's and a CPU copy's within
1e-5 of the largest, and ``align_bridge_dataset`` 32 subjects;
``run_bridge_loocv`` at BridgeConfig's widths, 32 folds of 10 epochs, IG
over 50 steps, has its pooled metrics recomputed from ``cv.test_probs``,
two folds' XAI equal to the attribution functions applied by hand (bit for
bit), and finite records and clinical values; ``Explainer.explain`` on the
frozen EEG model over 8 subjects launches K1-K3 as its structure says (7,
3, 3 per flash layer) at IG over 50 steps and over 8 (the steps are folded
into the batch), and its saliency, gradient×input and IG hold to the einsum
route and a CPU copy within 1e-4 of the largest (a route that broke one of
the ERP max-pool's ties at IG's zero baseline otherwise than the kernel
route is printed and rerun with the kernel route's choices; a choice made
otherwise at a pair that is no tie fails); Kernel SHAP on the bridge
(M = 192) and on the frozen EEG model (M = 48,075, 256 coalition rows in
one batch) holds to a CPU copy within 1e-5. A ``bridge`` JSON line holds
the timings.
Last, the serving slice (the serving phase: the rest of ``serving.py``,
``core/quantize.py``, ``report/uncertainty.py`` and ``report/drift.py``) at
MultimodalEndToEnd's defaults, T=512, batch 8, five members from five
seeds (member 0 trained 6 epochs on a separable cohort): gate a, a
``from_checkpoint`` round trip bit for bit; gate b, ``EnsemblePredictor``
against a host loop of five ``Predictor``s within 1e-5 for each reduction
(votes exactly), K1 launched 4 times per served batch (the member axis
folded into one launch per layer), and K1 on the folded (40, 4, 512, 32)
batch within 2e-5 of its plain version, with what the operator's dispatch
costs the host per call; gate c, exported programs of the
predictor and the ensemble, loaded again, within 1e-6 and launching K1;
gate d, int8 and int4 payloads written and served on the card within the
JAX tests' drift bounds (0.05, 0.15) with the same decisions, the int8 one
over 3× smaller; gate e, ``calibrated``; gate f, ``DynamicBatcher``: 32
threads' rows equal to the direct call, fewer calls than rows,
``QueueFull`` under a burst, ``close()`` draining; gate g, the ensemble's
uncertainty and a drift monitor on the card. A ``serving`` JSON line holds
the timings.
Then the model zoo (the zoo phase, after the cv phase): zoo-suite-T512
runs ``run_model_suite`` over the four models of the JAX package's EEG
experiment (``pipelines.run_eeg_experiment``: TriModalFusionNetV4,
SmartFusionNetV4, PWOnlyNet and ERPOnlyNet as it builds them from
EEGConfig, with its augmentation) over 66 subjects at T=512 in 5 folds, 2
epochs, each model's run timed and its K1-K3 launches held to the counts
derived from its flash layers, the fold length and whether its attention
dropout keeps the train steps on the einsum route (the two transformer
models: K1 in the evaluations only; the baselines: none); zoo-step-T512
runs SmartFusionNetV4 and TriModalFusionNetGNN (on (8, 18, 18, 3)
connectivity matrices) at dropout 0, batch 8, each launching K1, K2 and
K3 4 times in a forward and backward: gate a, a train step against the
einsum route and the CPU's (loss within 1e-5 of the einsum route's, and
of the CPU's plus 4× the einsum route's card-vs-CPU gap; each gradient
within 1e-4 plus 4× that tensor's own card-vs-CPU gap on that route, since
training-mode BatchNorm over 8 rows in the head amplifies f32 rounding);
gate b, an eval-mode backward against the einsum route and a float64 copy
(loss within 1e-5, each gradient within 3e-4 of its tensor's largest, and
within 1e-4 of the largest gradient); and one ``Predictor`` batch of the
GNN (4 K1 launches, logits within 1e-4 of the einsum route's). A ``zoo``
JSON line holds the suite's timings, and the kernels line each path's
launches.
Then the long-context slice (the lc phase, after the zoo phase):
lc-moe-T2048 trains ``LongContextClassifier`` at its JAX defaults (hidden
64, 2 layers, 4 heads: K1-K3 at D=16) with 4 experts, top-2, on raw EEG
(8, 2048, 18) through ``make_fit_fn`` (32 subjects with a class signal, 3
epochs, 8 validation rows) and serves it through ``Predictor(batch_size=8)``;
gate a, the launches derived from the steps, evaluations and served
batches (2 layers each); gate d, the served logits within 1e-4 of the
einsum route's; gate c, the same fit with ``remat=True``: its history within
1e-6 of the plain fit's, 2 more K1 a step, and both fits' peak memory;
gate b, one train step on the kernel route, the einsum route and the CPU
through ``step_gate`` (each gradient to its tensor's floor, as in the zoo
phase), after printing the tokens each route sends to other experts and
their top-k margins (a route with such flips runs again on the kernel
route's expert choices); gate f, the step's loss minus its task loss equal
to 0.01 · Σ aux over the blocks, and no aux from an eval forward; gate e,
``TriModalFusionNetV4(num_experts=4, moe_top_k=2, dropout=0.0)`` at T=512,
batch 8, one train step (4 launches of each kernel) through the same gate.
It times the steps (kernel route, einsum route, remat), the ``Predictor``,
the device time of a step split into K1-K3, the MoE layers and the rest,
and K1-K3 per call at (8, 4, 2048, 16) with their bound and SDPA's time;
an ``lc`` JSON line holds them.
Last, the experiment front-ends (the pipelines phase, after the serving
phase: ``pipelines.py``, ``__main__.py``, ``train/hpo.py`` and the file
loaders). K1-K3 take every head dim up to 128, padding the ones between
their instances (8, 12, 24, 48 here) to the next: the kernel-vs-plain
phases above run them at those head dims in f32 and bf16 storage, and the
timing phase times them at (8, 4, 512, 24) beside D=32. The phase serves
one ``Predictor`` batch of ``TriModalFusionNetV4(hidden_dim=96,
num_heads=4)`` at T=512 (head dim 24) against the einsum route;
pipelines-all-T512 writes a cohort in the reference's file formats (66 EEG
subjects' classic .mat conn, PW and ERP files for five bands and
``medical_score.csv``, 32 fMRI subjects' CSVs and labels) and runs
``__main__.main(["--pipeline", "all", ...])`` in process with a JSON config
at EEGConfig's full widths, T=512, one epoch: each pipeline timed, its
K1-K3 launches held to the counts derived from its models' flash layers,
folds and evaluations, the file ingest timed with its path (native or
numpy) printed, the headline metrics printed, the exported files checked;
hpo-default-T512 runs ``run_hpo(build_trimodal, ...)`` over DEFAULT_SPACE,
16 trials, on 66 synthetic subjects with matrix connectivity, every trial
finishing and K1's launches by head dim held to the derived count. A
``pipelines`` JSON line holds the timings.
Past head dim 128, K1, K2 and K3 run on the split tensor-core kernels
(``csrc/flash_fwd_split.cu``, ``csrc/flash_bwd_split.cu``, the head dim
padded to the instance 192 or 256) up to 256; past it K1 runs on the CUDA
cores (``csrc/flash_wide.cu``) and K2 and K3 on the deep tensor-core
kernels (``csrc/flash_bwd_deep.cu``, the head dim padded to a multiple of
64). The build prints every instance's registers, spills, stack frame and
HMMA count (a split or deep instance that is missing, spills, keeps a
stack frame or has no HMMA fails). The wide phase, after the bf16-storage
checks, holds them against their plain versions at (8, 4, 512, d), d in
(160, 192, 256, 257, 320, 384, 512), in f32 and bf16 storage and the
bf16-operand mode, each launch counted at its C entry point and launch
head dim, each kernel bit for bit on a second call; it times them at d =
160, 256, 320 and 512 in the three modes, beside the plain versions, the
bound and SDPA, and the deep K2 and K3 at 320 beside the CUDA-core
kernels' last times. lc-d256-T2048 and lc-d512-T2048 each take one train
step of ``LongContextClassifier(hidden_dim=512)`` with 2 heads (head dim
256) or 1 (head dim 512) on raw EEG (8, 2048, 18): 2 launches each of K1,
K2 and K3 (the split kernels at 256; the CUDA-core K1 and the deep K2 and
K3 at 512), the step gated against the einsum route and the CPU per
tensor (``lc_step_gate``), both routes timed, and K1-K3 timed per call at
the step's (8, 2, 2048, 256) or (8, 1, 2048, 512). The kernels line lists
the split K1, K2 and K3, and the CUDA-core K1 and the deep K2 and K3, as
kernels of their own.
Last, sequence parallelism (the ring phase, after the pipelines phase:
``parallel/``, ``ops/ring_attention.py``): lc-ring-T8192 trains
``LongContextClassifier`` at its JAX defaults with ``attn_impl="ring"``,
``ring_chunk_impl="flash"`` over a seq axis of 4 on raw EEG (8, 8192,
18), T_local 2048 (32 subjects, 3 epochs, 8 validation rows), in 4 ranks
spawned from this script (NCCL, a card each, where 4 cards exist; else
gloo on one card, the hops staged through host memory; the backend, the
ranks a card and the bytes staged printed). Gate a, its loss history
within rtol 2e-4, atol 2e-5 of the single-device flash fit at T=8192 from
the same weights, equal on every rank, as are the final params; gate b,
one step's loss within the history's bounds and its gradient per tensor
within 3e-4 of the single-device kernel route's and of a float64 einsum
copy's; gate c, the einsum-chunk ring
against the flash-chunk ring on 2 rows; gate d, each rank's launches
exactly (K1 = layers × ring size a forward, K2 = K3 = that a backward);
gate e, every K2/K3 call of the step given a nonzero lse cotangent, the
largest printed. lc-ring-heads takes one step on a (seq 2 × model 2) mesh
of the same world against the same references; a world of one over NCCL
gives the single-device flash logits within 2e-5. A ``ring`` JSON line
holds the times.
Any failed phase raises, so the exit code is not 0 and the final line is
not printed.
There is no CPU mode: without a GPU the script fails at once.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
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
GRID_CASE = (16400, 4, 64, 32)    # B·H past gridDim.y's 65,535
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


def count_hmma(sass: str, instance=kernel_instance) -> dict:
    """{instance: HMMA instructions} from the output of ``cuobjdump -sass``."""
    counts, current = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = instance(m[1])
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
    from multimodal_eeg_fmri_tpu_torch.ops.attention import DEEP_CHUNK

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
    wide = parse_ptxas("\n".join(outputs), wide_instance)
    for inst in sorted(wide):
        regs, st, ld, frame = wide[inst]
        print(f"{inst[0]} (any D past 128) {inst[1]} storage, {inst[2]} "
              f"operands: {regs} registers, spill stores/loads {st}/{ld} "
              f"bytes, stack frame {frame} bytes")
    if len(wide) != 4:
        fail(f"expected the 4 instances of the CUDA-core K1, ptxas listed "
             f"{sorted(wide)}")
    deep = parse_ptxas("\n".join(outputs), deep_instance)
    deep_hmma = count_hmma(sass, deep_instance)
    for inst in sorted(deep):
        regs, st, ld, frame = deep[inst]
        print(f"{inst[0]} (any D past 256, padded to {DEEP_CHUNK}) {inst[1]} "
              f"storage, {inst[2]} operands: {regs} registers, spill "
              f"stores/loads {st}/{ld} bytes, stack frame {frame} bytes, "
              f"{deep_hmma.get(inst, 0)} HMMA")
    if faults := instance_faults(DEEP_INSTANCES, deep, deep_hmma, "deep"):
        fail("; ".join(faults))
    split = parse_ptxas("\n".join(outputs), split_instance)
    split_hmma = count_hmma(sass, split_instance)
    for inst in sorted(split):
        regs, st, ld, frame = split[inst]
        print(f"{inst[0]} D={inst[1]} {inst[2]} storage, {inst[3]} operands: "
              f"{regs} registers, spill stores/loads {st}/{ld} bytes, stack "
              f"frame {frame} bytes, {split_hmma.get(inst, 0)} HMMA")
    if faults := instance_faults(SPLIT_INSTANCES, split, split_hmma,
                                 "split"):
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


def instance_faults(wanted: set, resources: dict, hmma: dict,
                    label: str) -> list:
    """What is wrong with the build of the ``label`` instances ``wanted``
    (``SPLIT_INSTANCES``: K1-K3 in (128, 256]; ``DEEP_INSTANCES``: K2 and
    K3 past 256), from ``parse_ptxas`` and ``count_hmma`` with their
    symbol reader: an instance missing from either, one with no HMMA
    instruction, or one that spills or keeps a stack frame (both designs
    bound each lane's D-wide sums whatever the head dim: at most 64 in the
    split kernels, 128 in the deep K2 and 64 in the deep K3)."""
    if missing := sorted(wanted - (set(resources) & set(hmma))):
        return [f"{label} instances missing from ptxas or SASS: {missing}"]
    faults = []
    if no_mma := sorted(i for i in wanted if hmma[i] == 0):
        faults.append(f"no HMMA instruction in {no_mma}")
    if local := sorted(i for i in wanted if any(resources[i][1:4])):
        faults.append(f"{label} instances with spills or a stack frame: "
                      f"{local}")
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
    it is then taken again, up to ``attempts`` times. Where every trace
    comes back empty (seen on the H100 late in a run: the CPU ops recorded
    and no kernel, the ops' names printed), the device time is not
    measured: (None, None), which the callers print as "not measured"."""
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
        free, total = torch.cuda.mem_get_info()
        ops = sorted(e.key for e in prof.key_averages())
        print(f"profile: no device time in a trace of {n} calls "
              f"({len(ops)} ops: {', '.join(ops[:8])}; device memory free "
              f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB); taken "
              "again after emptying the allocator's cache")
        torch.cuda.empty_cache()
        time.sleep(1.0)
    print(f"profile: no device time in {attempts} traces; the device time "
          "is not measured here")
    return None, None


def per_call_device_ms(kernels: list, n: int) -> tuple:
    """(ms, kernels) of one of ``n`` calls from (count, device us) per
    kernel in a trace: each kernel's mean time times round(count / n)."""
    per_call = [(round(count / n), us / count) for count, us in kernels
                if count]
    return (sum(k * t for k, t in per_call) / 1000.0,
            sum(k for k, _ in per_call))


def device_ms(fn, n: int = 50):
    """Mean device time of one call (``device_profile``), or None where
    the profiler recorded no kernel."""
    return device_profile(fn, n)[0]


def share(num, den, spec: str = ".1%") -> str:
    """num / den formatted by ``spec``, or "not measured" where either is
    None (a device time the profiler did not record)."""
    return ("not measured" if num is None or den is None
            else format(num / den, spec))


def profile_calls(fn, label: str, card: str, n: int = 5,
                  record: dict = None):
    """Device busy share and device time by op over n calls of ``fn``
    (torch.profiler); returns the busy share, or None (and goes on) if the
    trace has no device time. ``record``, if given, receives the busy ms a
    call and each kernel's device ms a call."""
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
    if record is not None:
        record["busy_ms"] = busy_ms
        record["kernels"] = {e.key: _device_us(e) / 1000.0 / n
                             for e in events}
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


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| over max|b| (0 where both are 0)."""
    return ((a - b).abs().max() / b.abs().max()).nan_to_num(0.0).item()


def step_gate(what: str, losses: dict, grads: dict, noisy: set,
              rtol: dict = None, loss_atol: dict = None) -> None:
    """The train-step gate: the kernel route's loss within its limit
    (``loss_atol`` by route, else STEP_LOSS_ATOL) of each other route's,
    and each gradient within its limit (``rtol`` by name, else
    STEP_GRAD_RTOL) of its tensor's largest |value|; the biases whose
    gradient is zero up to rounding (``noisy``) within STEP_GRAD_RTOL of
    the largest gradient of the first other route."""
    rtol, loss_atol = rtol or {}, loss_atol or {}
    g_max = max(g.abs().max().item()
                for g in next(v for r, v in grads.items()
                              if r != "kernel").values())
    for other in (r for r in grads if r != "kernel"):
        d_loss = abs(losses["kernel"] - losses[other])
        loss_limit = loss_atol.get(other, STEP_LOSS_ATOL)
        # the heads whose logits MultimodalEndToEnd does not use get
        # exactly zero gradient on every route
        rel = {k: rel_gap(grads["kernel"][k], g)
               for k, g in grads[other].items() if k not in noisy}
        worst_name = max(rel, key=lambda k: rel[k]
                         / rtol.get(k, STEP_GRAD_RTOL))
        limit = rtol.get(worst_name, STEP_GRAD_RTOL)
        d_noisy = max((grads["kernel"][k] - grads[other][k]).abs().max().item()
                      for k in noisy) / g_max
        print(f"{what}kernel vs {other}: loss {losses['kernel']:.7f} vs "
              f"{losses[other]:.7f} (|d|={d_loss:.3e}, limit "
              f"{loss_limit:.3e}); gradients max|d|/max|g| per tensor, "
              f"the nearest its limit: {rel[worst_name]:.3e} at {worst_name} "
              f"(limit {limit:.3e}); the {len(noisy)} biases whose gradient "
              f"is zero up to rounding: max|d| / the largest gradient "
              f"{d_noisy:.3e}")
        if not (d_loss <= loss_limit and rel[worst_name] <= limit
                and d_noisy <= STEP_GRAD_RTOL):
            fail(f"{what}the kernel route's train step disagrees with the "
                 f"{other} route")


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
        print(f"S1 {name}: sequential {seq_ms:.4f} ms (device "
              f"{_ms(seq_dev)}, {seq_kernels} kernels), rule's L={L} "
              f"{rule_ms:.4f} ms (device {_ms(rule_dev)}, {rule_kernels} "
              f"kernels): {share(seq_dev, rule_dev, '.2f')}x by device time; "
              f"bound "
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
            print(f"S1 {name}: by chunk length, device / events "
                  + ", ".join(f"{c}: {_ms(d)} / {e:.4f} ms"
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
                         epochs: int, folds: int, eval_sets: int = 2,
                         in_steps: bool = True) -> dict:
    """K1-K3 launches of a ``run_cv`` whose folds pad to ``train_rows``:
    per fold, each of ``layers`` flash layers runs K1 in every train step
    and every per-epoch evaluation, plus the final test evaluation, and K2
    and K3 in every train step. A model whose attention dropout is on
    trains on the einsum route (``in_steps`` False): K1 in the evaluations
    only."""
    steps = train_rows // min(batch, train_rows) if in_steps else 0
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


# --- the model zoo: the reference's four-model suite, K1-K3 in new models ---

ZOO_EPOCHS = 2                    # cut from TrainConfig's 50
# a train step's gradient gap in one tensor may be a few times that
# tensor's own f32 floor, the einsum route's gap between card and CPU
ZOO_FLOOR_FACTOR = 4
# the kernel route's eval-mode gradients, per tensor, over the tensor's
# largest: ~1e-4 measured in the q/k projections (ROADMAP C8)
ZOO_GRAD_RTOL = 3e-4
ZOO_STEP_MODELS = ("SmartFusionNetV4", "TriModalFusionNetGNN")


def zoo_suite_models(e, dev) -> dict:
    """The four models of ``pipelines.run_eeg_experiment``, built as it
    builds them from the EEGConfig ``e``."""
    from multimodal_eeg_fmri_tpu_torch.models import (
        ERPOnlyNet,
        PWOnlyNet,
        SmartFusionNetV4,
    )

    return {"trimodal": eeg_model(e, e.dropout, dev),
            "fusion": SmartFusionNetV4(
                hidden_dim=e.hidden_dim,
                num_transformer_layers=e.num_transformer_layers,
                num_heads=e.num_heads, erp_channels=e.erp_channels,
                pw_channels=e.pw_channels, device=dev),
            "pwonly": PWOnlyNet(hidden_dim=e.hidden_dim // 2,
                                pw_channels=e.pw_channels, device=dev),
            "erponly": ERPOnlyNet(hidden_dim=e.hidden_dim // 2,
                                  erp_channels=e.erp_channels, device=dev)}


def trains_on_the_kernels(model) -> bool:
    """Whether a train step may take K1-K3: the "auto" rule sends an
    attention layer with probability dropout to the einsum route."""
    from multimodal_eeg_fmri_tpu_torch.models.layers import MultiHeadAttention

    return not any(m.dropout for m in model.modules()
                   if isinstance(m, MultiHeadAttention))


def zoo_suite_phase(dev, card: str) -> dict:
    """zoo-suite-T512: ``run_model_suite`` over the reference's four models
    at EEGConfig's widths with the pipeline's augmentation, 66 subjects at
    T=512, 5 folds, ZOO_EPOCHS epochs. Each model's run is timed and its
    launches counted around its ``run_cv`` (the suite's loop calls it by
    name) and held to the counts derived from its flash layers, the fold
    length and whether it trains on the kernels."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        EEGConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
    from multimodal_eeg_fmri_tpu_torch.train import cv as cv_module

    e = EEGConfig()
    data = synthetic_eeg_trimodal(n_subjects=CV_EEG_N, time_steps=T_SERVE)
    cfg = TrainConfig(num_epochs=ZOO_EPOCHS)
    splits = cv_module.eeg_kfold_splits(data, cfg, n_splits=e.n_splits)
    stacks = cv_module.build_fold_arrays(data, splits, "scalar", EEG_KEYS)
    rows = stacks[0]["label"].shape[1]
    fold0 = {k: v[0] for k, v in stacks[0].items()}
    models = zoo_suite_models(e, dev)
    expected = {}
    for name, model in models.items():
        layers = flash_layers(model, fold0)
        expected[name] = cv_expected_launches(
            layers, rows, cfg.batch_size, ZOO_EPOCHS, len(splits),
            in_steps=trains_on_the_kernels(model))
        print(f"{name}: {type(model).__name__}, "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"{layers} flash layers a forward, trains on the kernels: "
              f"{trains_on_the_kernels(model)}")

    names = {id(m): name for name, m in models.items()}
    measured = {}
    run_cv = cv_module.run_cv

    def counted_run_cv(model, *args, **kw):
        reset_all_launches()
        out, seconds = timed(lambda: run_cv(model, *args, **kw))
        measured[names[id(model)]] = (total_launches(), seconds)
        return out

    augment = make_eeg_augment(noise_std=e.augment_noise_std,
                               channel_dropout=e.augment_channel_dropout,
                               prob=e.augment_prob)
    cv_module.run_cv = counted_run_cv
    try:
        results, seconds = timed(lambda: cv_module.run_model_suite(
            models, cfg, data, splits, normalize_keys=EEG_KEYS,
            augment=augment))
    finally:
        cv_module.run_cv = run_cv
    if list(results) != list(models) or list(measured) != list(models):
        fail(f"run_model_suite ran {list(measured)}, returned "
             f"{list(results)}")
    out = {"seconds": seconds, "models": {}}
    for name, result in results.items():
        launches, s = measured[name]
        what = f"zoo-suite-T{T_SERVE} {name}"
        print_cv(result, s, what, card)
        print(f"{what}: launches {launches} (expected {expected[name]})")
        if launches != expected[name]:
            fail(f"{what} launched {launches}, expected {expected[name]}")
        cv_finite(result, what)
        out["models"][name] = {"seconds_per_fold": s / result.n_folds,
                               "launches": launches,
                               "f1": result.summary["f1"]}
    print(f"zoo-suite-T{T_SERVE}: 4 models x {len(splits)} folds in "
          f"{seconds:.2f} s {card}")
    return out


def zoo_route_grads(m, batch: dict, cw, train: bool, cfg,
                    out_device, preprocess=zscore) -> tuple:
    """(loss, {name: gradient on ``out_device``}, launches) of one forward
    and backward of ``m`` on ``batch`` in ``m``'s device and dtype: a
    ``TrainStep``'s loss (with ``preprocess``) in training mode, or the
    same weighted cross-entropy on the eval-mode forward."""
    from multimodal_eeg_fmri_tpu_torch.ops.losses import (
        weighted_cross_entropy,
    )
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    p0 = next(m.parameters())
    batch = {k: v.to(p0.device, p0.dtype) if v.is_floating_point()
             else v.to(p0.device) for k, v in batch.items()}
    cw = cw.to(p0.device, p0.dtype)
    reset_all_launches()
    if train:
        loss = TrainStep(m, cfg, preprocess=preprocess).loss(batch, cw)
    else:
        inputs = {**{k: batch[k] for k in ("erp", "pw", "conn")},
                  **zscore(batch)}
        loss = weighted_cross_entropy(m.eval()(**inputs).logits,
                                      batch["label"], cw, batch["weight"])
    loss.backward()
    torch.cuda.synchronize()
    return (loss.item(), {k: p.grad.to(out_device)
                          for k, p in m.named_parameters()},
            total_launches())


def zoo_step_phase(dev, card: str) -> dict:
    """zoo-step-T512: SmartFusionNetV4 and TriModalFusionNetGNN at
    EEGConfig's widths, dropout 0, batch 8 (the GNN on (8, 18, 18, 3)
    connectivity matrices), each from one set of weights on the kernel
    route, the einsum route and the CPU's einsum route. Each launches K1,
    K2 and K3 once per temporal layer (4) in a forward and backward.

    Gate a, one train step: the launches; ``step_gate`` against the einsum
    route and against the CPU's, with each gradient's limit (max|d| over
    its tensor's largest) STEP_GRAD_RTOL plus ZOO_FLOOR_FACTOR times that
    tensor's floor, the gap between the einsum route on the card and on
    the CPU; the loss within STEP_LOSS_ATOL of the einsum route's, and of
    the CPU's plus ZOO_FLOOR_FACTOR times the loss's own floor. Training-mode BatchNorm over 8 rows of nearly equal pooled
    features in the head amplifies f32 rounding (E[x²] − E[x]² cancels),
    so that two f32 computations of the einsum route part by up to ~1e-3
    in a tensor: the train-step gate's 1e-4 alone is below the step's own
    floor.
    Gate b, the same weights and batch in eval mode (BatchNorm an affine
    map), a forward and a backward: ``step_gate`` against the einsum route
    and against the einsum route of a float64 copy of the model, each
    gradient within ZOO_GRAD_RTOL of its tensor's largest (the flash
    backward's Δ = rowsum(dO∘O) carries O's rounding into dS, whose rows
    should sum to zero, and keys with a large common part amplify it in
    the query and key projections); and every gradient within
    STEP_GRAD_RTOL of the largest gradient of the float64 copy.
    Then one ``Predictor`` batch of the GNN: 4 K1 launches, logits within
    LOGITS_ATOL of the einsum route's."""
    from multimodal_eeg_fmri_tpu_torch import (
        Predictor,
        TrainConfig,
        init_weights,
    )
    from multimodal_eeg_fmri_tpu_torch.core.config import EEGConfig
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.models import (
        SmartFusionNetV4,
        TriModalFusionNetGNN,
    )
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion

    e = EEGConfig()
    widths = dict(hidden_dim=e.hidden_dim, dropout=0.0,
                  num_transformer_layers=e.num_transformer_layers,
                  num_heads=e.num_heads, erp_channels=e.erp_channels,
                  pw_channels=e.pw_channels, device=dev)
    data = synthetic_eeg_trimodal(n_subjects=BATCH, time_steps=T_SERVE,
                                  conn_as_matrix=True)
    batch = {k: torch.as_tensor(data[k], device=dev)
             for k in ("erp", "pw", "conn", "label")}
    batch["weight"] = torch.ones(BATCH, device=dev)
    cw = torch.ones(2, device=dev)
    cfg = TrainConfig(batch_size=BATCH)
    per_step = 2 * e.num_transformer_layers   # the ERP and PW encoders
    expected = dict.fromkeys(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
                             per_step)
    none = dict.fromkeys(expected, 0)
    out = {}
    for cls in (SmartFusionNetV4, TriModalFusionNetGNN):
        base = init_weights(cls(**widths), torch.Generator().manual_seed(4))
        for m in base.modules():
            if isinstance(m, LearnedFusion):
                m.gate_dropout = 0.0
        name = cls.__name__
        noisy = cancelled_biases(base)
        runs = {}
        for mode, routes in (
                ("train", (("kernel", copy.deepcopy(base)),
                           ("einsum", einsum_route(copy.deepcopy(base))),
                           ("cpu", einsum_route(copy.deepcopy(base).cpu())))),
                ("eval", (("kernel", copy.deepcopy(base)),
                          ("einsum", einsum_route(copy.deepcopy(base))),
                          ("f64",
                           einsum_route(copy.deepcopy(base)).double())))):
            for route, m in routes:
                runs[mode, route] = zoo_route_grads(
                    m, batch, cw, mode == "train", cfg, dev)
            launches = {r: runs[mode, r][2] for r in ("kernel", "einsum")}
            print(f"zoo-step-T{T_SERVE} {name}, {mode} mode: launches, "
                  f"kernel route {launches['kernel']}, einsum route "
                  f"{launches['einsum']} (expected {expected} and none)")
            if launches != {"kernel": expected, "einsum": none}:
                fail(f"zoo-step-T{T_SERVE} {name}, {mode} mode, launched "
                     f"{launches}")
        out[name] = runs["train", "kernel"][2]

        what = f"zoo-step-T{T_SERVE} {name}, gate a (train step): "
        losses, grads = ({r: runs["train", r][i]
                          for r in ("kernel", "einsum", "cpu")}
                         for i in (0, 1))
        loss_floor = abs(losses["einsum"] - losses["cpu"])
        floor = {k: rel_gap(grads["einsum"][k], g)
                 for k, g in grads["cpu"].items() if k not in noisy}
        top = max(floor, key=floor.get)
        print(f"{what}the einsum route, card vs CPU: loss |d|="
              f"{loss_floor:.3e}; gradients max|d|/max|g| per tensor up to "
              f"{floor[top]:.3e} at {top}")
        # the CPU's loss carries the floor in it: it is held to the floor
        # too, the einsum route's to STEP_LOSS_ATOL alone
        step_gate(what, losses, grads, noisy,
                  {k: STEP_GRAD_RTOL + ZOO_FLOOR_FACTOR * f
                   for k, f in floor.items()},
                  {"cpu": STEP_LOSS_ATOL + ZOO_FLOOR_FACTOR * loss_floor})

        what = f"zoo-step-T{T_SERVE} {name}, gate b (eval mode): "
        losses, grads = ({r: runs["eval", r][i]
                          for r in ("kernel", "einsum", "f64")}
                         for i in (0, 1))
        # in eval mode only the key-projection biases cancel
        key_biases = {k for k in noisy if k.endswith(".k_proj.bias")}
        step_gate(what, losses, grads, key_biases,
                  dict.fromkeys(grads["f64"], ZOO_GRAD_RTOL))
        g_max = max(g.abs().max().item() for g in grads["f64"].values())
        for r in ("kernel", "einsum"):
            d_max, at = max(((grads[r][k] - g).abs().max().item(), k)
                            for k, g in grads["f64"].items())
            rel, worst = max((rel_gap(grads[r][k], g), k)
                             for k, g in grads["f64"].items()
                             if k not in key_biases)
            print(f"{what}{r} route vs the float64 einsum route: gradients "
                  f"max|d| / the largest gradient {d_max / g_max:.3e} at {at}"
                  f" (limit {STEP_GRAD_RTOL:g}); per tensor max|d|/max|g| up "
                  f"to {rel:.3e} at {worst}")
            if r == "kernel" and d_max > STEP_GRAD_RTOL * g_max:
                fail(f"{what}the kernel route disagrees with the float64 "
                     "route")

        if cls is TriModalFusionNetGNN:
            request_rows = {k: data[k] for k in ("erp", "pw", "conn")}
            reset_all_launches()
            logits = Predictor(base, BATCH, return_probs=False)(
                **request_rows)
            torch.cuda.synchronize()
            served = total_launches()
            plain = Predictor(einsum_route(copy.deepcopy(base)), BATCH,
                              return_probs=False)(**request_rows)
            d = float(np.abs(logits - plain).max())
            print(f"zoo-serve-gnn-T{T_SERVE}: Predictor batch of {BATCH}, "
                  f"launches {served}, logits shape {logits.shape}, kernel "
                  f"vs einsum route max|d|={d:.3e} (limit {LOGITS_ATOL:g})")
            if served != {**none, "flash_fwd": per_step}:
                fail(f"the GNN's Predictor batch launched {served}")
            if not (logits.shape == (BATCH, 2) and np.all(np.isfinite(logits))
                    and d <= LOGITS_ATOL):
                fail("the GNN's Predictor batch disagrees with the einsum "
                     "route or is not finite")
            out["serve_gnn"] = served["flash_fwd"]
    return out


def zoo_phase(dev, card: str) -> dict:
    """The zoo phase: the four-model suite, then the train steps and the
    Predictor batch of the two new models that run K1-K3."""
    phase(f"zoo-suite-T{T_SERVE}: run_model_suite of trimodal, fusion, "
          f"pwonly and erponly at EEGConfig's widths, {CV_EEG_N} subjects, "
          f"5 folds, {ZOO_EPOCHS} epochs")
    suite = zoo_suite_phase(dev, card)
    phase(f"zoo-step-T{T_SERVE}: {' and '.join(ZOO_STEP_MODELS)} at "
          "dropout 0, batch 8: a train step and an eval-mode backward on the "
          "kernel route, the einsum route and a reference; a Predictor "
          "batch of the GNN")
    steps = zoo_step_phase(dev, card)
    print(json.dumps({"zoo": {"suite_T512": suite, "device": card}}))
    return {"suite": suite, "steps": steps}


# --- the long-context slice: LongContextClassifier with MoE, K1-K3 at D=16 --

LC_T, LC_EXPERTS, LC_TOP_K = 2048, 4, 2   # 8.2 s at 250 Hz; 4 experts, top-2
LC_COHORT, LC_VAL, LC_EPOCHS = 32, 8, 3
LC_SERVE_ROWS = 12                 # two Predictor batches, the last padded
LC_REMAT_ATOL = 1e-6               # the remat fit's history, of the plain fit's
LC_AUX_RTOL = 1e-6                 # the step's aux loss, of 0.01 · Σ aux
LC_KERNEL_SHAPE = (8, 4, LC_T, 16)  # K1-K3 in both layers: 64 over 4 heads


def lc_cohort(n: int, T: int, seed: int, dev) -> dict:
    """n subjects' raw EEG (n, T, 18) on the card, half of each class,
    class 1 with its channels' mean shifted by 0.3 (the class signal)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    label = torch.arange(n, device=dev) % 2
    erp = (torch.randn(n, T, 18, device=dev, generator=gen)
           + 0.3 * label[:, None, None])
    return {"erp": erp, "label": label, "weight": torch.ones(n, device=dev)}


def lc_model(dev, remat: bool = False, seed: int = 0):
    """``LongContextClassifier`` at its JAX defaults (hidden 64, 2 layers,
    4 heads, patch 1, dropout 0) with 4 experts, top-2, flax's initial
    weights from ``seed``."""
    from multimodal_eeg_fmri_tpu_torch import init_weights
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier

    return init_weights(
        LongContextClassifier(num_experts=LC_EXPERTS, moe_top_k=LC_TOP_K,
                              remat=remat, device=dev),
        torch.Generator().manual_seed(seed))


def lc_expected(layers: int, steps: int, evals: int, served: int,
                remat: bool = False) -> dict:
    """K1-K3 launches: K1 in every train step, evaluation and served batch
    (and again in a remat step's backward), K2 and K3 in every train step,
    once a layer each."""
    return {"flash_fwd": layers * ((2 if remat else 1) * steps + evals
                                   + served),
            "flash_bwd_dkv": layers * steps, "flash_bwd_dq": layers * steps}


@contextlib.contextmanager
def routing_recorded(calls: list, pinned: list = None):
    """Record every ``top_k_choices`` call of the MoE layers as (sorted
    router probabilities (S, E), top-k indices (S, k)); with ``pinned``,
    the recordings of another run, take their indices in call order
    instead of this run's own (the gates still come from this run's
    probabilities)."""
    from multimodal_eeg_fmri_tpu_torch.ops import moe

    real = moe.top_k_choices
    given = iter(pinned or ())

    def choices(probs, k):
        top_p, top_i = real(probs, k)
        if pinned is not None:
            top_i = next(given)[1].to(probs.device)
            top_p = probs.gather(-1, top_i)
        calls.append((torch.sort(probs.detach(), -1, descending=True)[0],
                      top_i))
        return top_p, top_i

    moe.top_k_choices = choices
    try:
        yield calls
    finally:
        moe.top_k_choices = real


def print_flips(what: str, records: dict) -> dict:
    """Tokens routed to other experts, or in another order, than on the
    kernel route, per other route and MoE call, with the smallest top-k
    margin among them (the gap between adjacent probabilities among a
    token's first k+1 on the kernel route); returns the flips by route."""
    flips = {}
    for other in (r for r in records if r != "kernel"):
        flips[other] = 0
        for call, ((p_k, i_k), (_, i_o)) in enumerate(
                zip(records["kernel"], records[other], strict=True)):
            k = i_k.shape[1]
            margin = (p_k[:, :k] - p_k[:, 1:k + 1]).amin(-1)
            flipped = (i_k != i_o.to(i_k.device)).any(-1)
            n = int(flipped.sum())
            flips[other] += n
            least = margin[flipped].min().item() if n else float("nan")
            print(f"{what}MoE call {call}, kernel vs {other} route: {n} of "
                  f"{len(flipped)} tokens routed otherwise (smallest top-k "
                  f"margin among them {least:.3e}; over all tokens "
                  f"{margin.min().item():.3e})")
    return flips


def lc_step_gate(base, batch: dict, cfg, cw, dev, what: str,
                 preprocess) -> dict:
    """One train step of ``base`` on the kernel route, the einsum route
    and the CPU's einsum route. The tokens each route sends elsewhere than
    the kernel route are printed with their margins; a route with such
    flips is run again with the kernel route's expert choices, so that
    every token routes alike (a near-tie flip moves a token's output by
    O(1), which no rounding limit can hold). Then ``step_gate`` with each
    gradient's limit STEP_GRAD_RTOL plus ZOO_FLOOR_FACTOR times its
    tensor's floor (the einsum route, card against CPU), as in the zoo
    phase. Returns the kernel route's and the einsum route's launches and
    the flips."""
    from multimodal_eeg_fmri_tpu_torch.models.fusion import LearnedFusion

    for m in base.modules():
        if isinstance(m, LearnedFusion):
            m.gate_dropout = 0.0
    models = {"kernel": copy.deepcopy(base),
              "einsum": einsum_route(copy.deepcopy(base)),
              "cpu": einsum_route(copy.deepcopy(base).cpu())}
    runs, records = {}, {}

    def run(route, pinned=None):
        m = copy.deepcopy(models[route])
        with routing_recorded([], pinned) as calls:
            runs[route] = zoo_route_grads(m, batch, cw, True, cfg, dev,
                                          preprocess)
        return calls

    for route in models:
        records[route] = run(route)
    flips = print_flips(what, records)
    for route, n in flips.items():
        if n:
            print(f"{what}the {route} route again with the kernel route's "
                  "expert choices")
            run(route, records["kernel"])
    noisy = cancelled_biases(base)
    losses, grads = ({r: runs[r][i] for r in runs} for i in (0, 1))
    loss_floor = abs(losses["einsum"] - losses["cpu"])
    floor = {k: rel_gap(grads["einsum"][k], g)
             for k, g in grads["cpu"].items() if k not in noisy}
    top = max(floor, key=floor.get)
    print(f"{what}the einsum route, card vs CPU: loss |d|={loss_floor:.3e}; "
          f"gradients max|d|/max|g| per tensor up to {floor[top]:.3e} at "
          f"{top}")
    step_gate(what, losses, grads, noisy,
              {k: STEP_GRAD_RTOL + ZOO_FLOOR_FACTOR * f
               for k, f in floor.items()},
              {"cpu": STEP_LOSS_ATOL + ZOO_FLOOR_FACTOR * loss_floor})
    return {"kernel": runs["kernel"][2], "einsum": runs["einsum"][2],
            "flips": flips}


def lc_fit(model, cfg, cohort: dict, val: dict, dev) -> tuple:
    """(FitResult, seconds, launches, peak bytes allocated) of a fit of
    ``model`` from seed 0."""
    from multimodal_eeg_fmri_tpu_torch import make_fit_fn

    fit = make_fit_fn(model, cfg, eval_names=("val",))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    result, seconds = timed(lambda: fit(0, cohort, {"val": val},
                                        torch.ones(2, device=dev)))
    return (result, seconds, total_launches(),
            torch.cuda.max_memory_allocated(dev))


def lc_aux_gate(model, batch: dict, cfg, cw) -> dict:
    """Gate f: a train-mode loss minus its task loss is 0.01 · Σ aux over
    the blocks (each block's aux as ``top_k_routing`` returned it); an
    eval forward leaves no aux loss."""
    from multimodal_eeg_fmri_tpu_torch.ops import moe
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    step = TrainStep(model, cfg)
    raw, real = [], moe.top_k_routing

    def recorded(*a):
        out = real(*a)
        raw.append(out[2].item())
        return out

    moe.top_k_routing = recorded
    try:
        task, aux = step.losses(batch, cw)
    finally:
        moe.top_k_routing = real
    loss = (task + aux).item()
    with torch.no_grad(), moe.collect_aux_losses() as sink:
        model.eval()(erp=batch["erp"])
    weight = model.block_0.moe.aux_weight
    want = sum(weight * a for a in raw)
    got = loss - task.item()
    # the difference of two f32 numbers near the loss: its rounding
    limit = LC_AUX_RTOL * want + 2 * float(np.spacing(np.float32(loss)))
    print(f"gate f: train-mode loss {loss:.7f} - task loss {task.item():.7f}"
          f" = {got:.7e}; {weight:g} · Σ aux over {len(raw)} blocks "
          f"{want:.7e} (aux per block {', '.join(f'{a:.6f}' for a in raw)}; "
          f"limit {limit:.3e}); the step's aux {aux.item():.7e}; an eval "
          f"forward left {len(sink)} aux losses")
    if not (len(raw) == model.num_layers and not sink
            and abs(aux.item() - want) <= LC_AUX_RTOL * want
            and abs(got - want) <= limit):
        fail("gate f: the train-mode loss does not add 0.01 · Σ aux, or an "
             "eval forward left an aux loss")
    return {"aux": want, "blocks": raw}


def moe_layer_ms(dev, rows: int, T: int, d: int) -> float:
    """ms of one MoE FFN forward and backward (the model's 2 layers take
    twice this) on an input of the model's shape, by CUDA events: its
    kernels keep the card busy, so this is its device time."""
    from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN

    moe = MoEFFN(d, LC_EXPERTS, top_k=LC_TOP_K, device=dev).train()
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(rows, T, d, device=dev, generator=gen,
                    requires_grad=True)
    g = torch.randn(rows, T, d, device=dev, generator=gen)

    def fwd_bwd():
        torch.autograd.grad(moe(x), (x, *moe.parameters()), g)

    return cuda_ms(fwd_bwd, iters=5, warmup=2)


def kernel_call_times(q, k, v, g, storage: str, card: str,
                      iters: int = 200, n: int = 50) -> dict:
    """K1, K2 and K3 per call on (q, k, v) with cotangent g, printed and
    returned by kernel: CUDA events around ``iters`` calls and the
    profiler's device time over ``n`` (with ``n`` 0, None: not measured
    here), their plain versions in turns, the bound, and SDPA's forward
    or backward on the same inputs."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain,
        flash_bwd_dq_cuda,
        flash_bwd_dq_plain,
        flash_delta,
        flash_forward_cuda,
        flash_forward_plain,
    )

    B, H, T, d = q.shape
    out, lse = flash_forward_cuda(q, k, v)
    delta = flash_delta(out, g)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl)

    def lib_fwd():
        return sdpa(q, k, v)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                   retain_graph=True)

    lib_times = {f: (cuda_ms(f, iters), device_ms(f, n) if n else None)
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
    times = {}
    for name, (kern, plain, lib_fn) in pairs.items():
        ms, plain_ms = in_turns(lambda: cuda_ms(kern, iters),
                                lambda: cuda_ms(plain, iters))
        dev_ms = device_ms(kern, n) if n else None
        lib_ms, lib_dev_ms = lib_times[lib_fn]
        b_ms, by = bound_ms(name, B, H, T, T, d, storage)
        times[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": by,
                       "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
        print(f"{name} (B,H,T,D)=({B},{H},{T},{d}) {storage} storage: "
              f"kernel {ms:.4f} ms "
              f"(device {_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}), library (SDPA "
              f"{'forward' if name == 'flash_fwd' else 'backward, dQ+dK+dV'}"
              f") {lib_ms:.4f} ms (device {_ms(lib_dev_ms)}) per call "
              f"{card}")
    return times


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def lc_kernel_times(dev, card: str) -> dict:
    """K1-K3 per call at LC_KERNEL_SHAPE (``kernel_call_times``) by CUDA
    events; the phase takes their device time from the train step's
    trace."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, g = (torch.randn(*LC_KERNEL_SHAPE, device=dev, generator=gen)
                  for _ in range(4))
    return {name: {"shape": list(LC_KERNEL_SHAPE), **t} for name, t in
            kernel_call_times(q, k, v, g, "f32", card, iters=50,
                              n=0).items()}


def lc_phase(dev, card: str) -> dict:
    """lc-moe-T2048: ``LongContextClassifier`` at its JAX defaults with 4
    experts, top-2, over raw EEG (8, 2048, 18), through ``make_fit_fn`` (a
    32-subject cohort with a class signal, 3 epochs, batch 8, 8 validation
    rows), ``Predictor(batch_size=8)``, and the same fit with
    ``remat=True``; then the V4-MoE step. Gates a-f as the module's
    docstring lists them."""
    from multimodal_eeg_fmri_tpu_torch import (
        Predictor,
        TrainConfig,
        init_weights,
    )
    from multimodal_eeg_fmri_tpu_torch.core.config import EEGConfig
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.models import TriModalFusionNetV4
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    cohort = lc_cohort(LC_COHORT, LC_T, 50, dev)
    val = lc_cohort(LC_VAL, LC_T, 51, dev)
    cfg = TrainConfig(batch_size=BATCH, num_epochs=LC_EPOCHS,
                      learning_rate=1e-3, weight_decay=1e-5, grad_clip=1.0,
                      loss="weighted_ce", selection="val")
    cw = torch.ones(2, device=dev)
    steps = LC_EPOCHS * (LC_COHORT // BATCH)
    out = {"launches": {}}

    phase(f"lc-moe-T{LC_T}, gate a: make_fit_fn, {LC_COHORT} subjects + "
          f"{LC_VAL} val rows, {LC_EPOCHS} epochs, batch {BATCH}; "
          f"Predictor(batch_size={BATCH}) over {LC_SERVE_ROWS} rows")
    model = lc_model(dev, seed=1)
    layers = model.num_layers
    result, fit_s, launches, peak = lc_fit(model, cfg, cohort, val, dev)
    want = lc_expected(layers, steps, LC_EPOCHS, 0)
    history = {k: v.cpu().numpy() for k, v in result.history.items()}
    print(f"fit: {steps} steps and {LC_EPOCHS} evals in {fit_s:.2f} s "
          f"({1000 * fit_s / steps:.1f} ms a step, evaluations included); "
          f"peak memory {peak / 2**30:.2f} GiB; launches {launches} "
          f"(expected {want}) {card}")
    print("history: " + ", ".join(f"{k}={np.array2string(v, precision=6)}"
                                  for k, v in history.items()))
    if launches != want:
        fail(f"lc-moe-T{LC_T} fit launched {launches}, expected {want}")
    if not all(np.all(np.isfinite(v)) and v.shape == (LC_EPOCHS,)
               for v in history.values()):
        fail(f"lc-moe-T{LC_T}: non-finite or short history")
    out["launches"]["fit"] = launches
    rows = {"erp": val["erp"][:LC_SERVE_ROWS // 2].repeat(2, 1, 1).cpu()
            .numpy()}
    served_batches = -(-LC_SERVE_ROWS // BATCH)
    predictor = Predictor(model, batch_size=BATCH, return_probs=False)
    reset_all_launches()
    logits = predictor(**rows)
    torch.cuda.synchronize()
    served = total_launches()
    want_served = lc_expected(layers, 0, 0, served_batches)
    print(f"Predictor: {LC_SERVE_ROWS} rows in {served_batches} batches, "
          f"logits {logits.shape}, launches {served} (expected "
          f"{want_served})")
    if served != want_served:
        fail(f"lc-moe-T{LC_T} serving launched {served}, expected "
             f"{want_served}")
    out["launches"]["serve"] = served

    phase(f"lc-moe-T{LC_T}, gate d: Predictor logits, kernel vs einsum route")
    plain = Predictor(einsum_route(copy.deepcopy(model)), BATCH,
                      return_probs=False)
    records, served_logits = {}, {}
    for route, p in (("kernel", predictor), ("einsum", plain)):
        with routing_recorded([]) as records[route]:
            served_logits[route] = p(**rows)
    if print_flips("gate d: ", records)["einsum"]:
        print("gate d: the einsum route again with the kernel route's "
              "expert choices")
        with routing_recorded([], records["kernel"]):
            served_logits["einsum"] = plain(**rows)
    plain_logits = served_logits["einsum"]
    d_serve = float(np.abs(logits - plain_logits).max())
    print(f"logits {logits.shape}, finite {np.all(np.isfinite(logits))}; "
          f"kernel vs einsum route max|d|={d_serve:.3e} (limit "
          f"{LOGITS_ATOL:g})")
    if not (logits.shape == (LC_SERVE_ROWS, 2) and np.all(np.isfinite(logits))
            and d_serve <= LOGITS_ATOL):
        fail(f"lc-moe-T{LC_T}: served logits disagree with the einsum route")

    phase(f"lc-moe-T{LC_T}, gate c: the same fit with remat=True")
    remat_model = lc_model(dev, remat=True, seed=1)
    r_result, r_s, r_launches, r_peak = lc_fit(remat_model, cfg, cohort, val,
                                               dev)
    r_want = lc_expected(layers, steps, LC_EPOCHS, 0, remat=True)
    r_gap = max_diff(r_result.history, result.history)
    print(f"remat fit: {r_s:.2f} s; peak memory {r_peak / 2**30:.2f} GiB "
          f"(without remat {peak / 2**30:.2f} GiB); launches {r_launches} "
          f"(expected {r_want}); history max|d| against the plain fit "
          f"{r_gap:.3e} (limit {LC_REMAT_ATOL:g}) {card}")
    if r_launches != r_want or not r_gap <= LC_REMAT_ATOL:
        fail(f"lc-moe-T{LC_T}: the remat fit launched {r_launches} or parts "
             f"from the plain fit by {r_gap:.3e}")
    out["launches"]["remat_fit"] = r_launches
    out["peak_bytes"] = {"plain": peak, "remat": r_peak}

    phase(f"lc-moe-T{LC_T}, gate b: one train step, kernel vs einsum route "
          "and the CPU")
    batch = {k: v[:BATCH] for k, v in cohort.items()}
    base = lc_model(dev, seed=2)
    gate_b = lc_step_gate(base, batch, cfg, cw, dev,
                          f"lc-moe-T{LC_T}, gate b: ", None)
    if (gate_b["kernel"], gate_b["einsum"]) != (
            lc_expected(layers, 1, 0, 0), lc_expected(0, 0, 0, 0)):
        fail(f"lc-moe-T{LC_T}: the step launched {gate_b}")
    out["launches"]["step"] = gate_b["kernel"]
    out["flips"] = {"lc_step": gate_b["flips"]}

    phase(f"lc-moe-T{LC_T}, gate f: the aux loss")
    out["aux"] = lc_aux_gate(copy.deepcopy(base), batch, cfg, cw)

    e = EEGConfig()
    phase(f"v4-moe-T{T_SERVE}, gate e: TriModalFusionNetV4(num_experts="
          f"{LC_EXPERTS}, moe_top_k={LC_TOP_K}, dropout=0.0) at EEGConfig's "
          f"widths, batch {BATCH}: one train step")
    data = synthetic_eeg_trimodal(n_subjects=BATCH, time_steps=T_SERVE)
    v4_batch = {k: torch.as_tensor(data[k], device=dev)
                for k in ("erp", "pw", "conn", "label")}
    v4_batch["weight"] = torch.ones(BATCH, device=dev)
    v4 = init_weights(TriModalFusionNetV4(
        hidden_dim=e.hidden_dim, dropout=0.0,
        num_transformer_layers=e.num_transformer_layers,
        num_heads=e.num_heads, device=dev, num_experts=LC_EXPERTS,
        moe_top_k=LC_TOP_K), torch.Generator().manual_seed(5))
    v4_launches = lc_step_gate(v4, v4_batch, TrainConfig(batch_size=BATCH),
                               cw, dev, f"v4-moe-T{T_SERVE}, gate e: ",
                               zscore)
    out["flips"]["v4_step"] = v4_launches["flips"]
    v4_want = lc_expected(2 * e.num_transformer_layers, 1, 0, 0)
    print(f"v4-moe-T{T_SERVE}: launches {v4_launches['kernel']} (expected "
          f"{v4_want})")
    if v4_launches["kernel"] != v4_want:
        fail(f"v4-moe-T{T_SERVE} launched {v4_launches['kernel']}")
    out["launches"]["v4_step"] = v4_launches["kernel"]

    phase(f"lc-moe-T{LC_T} timing {card}")
    del remat_model, r_result, base, v4, plain, predictor
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"device memory free {free / 2**30:.2f} of {total / 2**30:.2f} GiB"
          f", reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    stats = Predictor(model, batch_size=BATCH).benchmark(
        {"erp": rows["erp"][:BATCH]}, warmup=3, iters=20)
    timed_steps = {
        "kernel": TrainStep(lc_model(dev, seed=3), cfg),
        "einsum": TrainStep(einsum_route(lc_model(dev, seed=3)), cfg),
        "remat": TrainStep(lc_model(dev, remat=True, seed=3), cfg)}
    kernel_ms, einsum_ms = in_turns(
        lambda: step_ms(timed_steps["kernel"], batch, cw, iters=10),
        lambda: step_ms(timed_steps["einsum"], batch, cw, iters=10))
    remat_ms = step_ms(timed_steps["remat"], batch, cw, iters=10)
    print(f"train step B={BATCH} T={LC_T}: kernel route {kernel_ms:.3f} ms, "
          f"einsum route {einsum_ms:.3f} ms, remat {remat_ms:.3f} ms; "
          f"Predictor p50 {stats['p50_ms']:.3f} ms, p95 "
          f"{stats['p95_ms']:.3f} ms {card}")
    # one trace in this phase: late in this script a trace may come back
    # without device events, and the next ones too (PERF.md §7)
    trace = {"busy_ms": None, "kernels": {}}
    busy = profile_calls(lambda: timed_steps["kernel"](batch, cw),
                         f"5 train steps B={BATCH} T={LC_T} kernel route",
                         card, record=trace)
    kernels = lc_kernel_times(dev, card)
    moe_ms = layers * moe_layer_ms(dev, BATCH, LC_T, 64)
    # K1-K3's device time by name in the step's trace: each runs once a
    # layer in a step
    for name, t in kernels.items():
        t["device_ms"] = next((ms / layers for key, ms in
                               trace["kernels"].items()
                               if f"{name}_kernel<" in key), None)
    step_device = trace["busy_ms"]
    flash_ms = rest = None
    if step_device is not None:
        flash_ms = sum(layers * t["device_ms"] for t in kernels.values())
        rest = step_device - flash_ms - moe_ms
        print(f"device time a step {step_device:.3f} ms: K1-K3 "
              f"{flash_ms:.3f} ms ({100 * flash_ms / step_device:.1f}%), the "
              f"MoE layers {moe_ms:.3f} ms by events "
              f"({100 * moe_ms / step_device:.1f}%), the rest {rest:.3f} ms "
              f"({100 * rest / step_device:.1f}%) {card}")
    else:
        print(f"device time a step: not measured (no device time in the "
              f"trace); the MoE layers {moe_ms:.3f} ms by events {card}")
    out["times"] = {"step_ms": kernel_ms, "einsum_step_ms": einsum_ms,
                    "remat_step_ms": remat_ms, "fit_s": fit_s,
                    "remat_fit_s": r_s, "predictor_p50_ms": stats["p50_ms"],
                    "predictor_p95_ms": stats["p95_ms"], "busy_share": busy,
                    "step_device_ms": step_device, "flash_device_ms": flash_ms,
                    "moe_device_ms": moe_ms, "rest_device_ms": rest,
                    "peak_gib": peak / 2**30, "remat_peak_gib": r_peak / 2**30}
    out["kernels"] = kernels
    print(json.dumps({"lc": {**out["times"], "flips": out["flips"],
                             "device": card}}))
    return out


# --- the bridge slice: xai/ and train/bridge_flow.py on the card ------------

STAGE1_EPOCHS, BRIDGE_EPOCHS = 3, 10      # cut from the configs' 50 each
BRIDGE_IG_STEPS = 50                      # run_bridge_loocv's default
XAI_ROWS, XAI_IG_STEPS, XAI_ROUTE_STEPS, XAI_CPU_ROWS = 8, 50, 8, 2
SHAP_BRIDGE_SAMPLES, SHAP_EEG_ROWS, SHAP_EEG_SAMPLES = 100, 4, 64
EXTRACT_RTOL = 1e-5       # embeddings, route against route, of the largest
ATTR_RTOL = 1e-4          # attributions, route against route, of the largest
# SHAP, card against CPU, of the largest: every coalition row's probability
# (what the card computes), and the bridge's Shapley values; the EEG model's
# 64 coalitions under-determine its 48,075 values, and the least squares
# amplifies the probabilities' f32 rounding there (printed, not gated)
SHAP_RTOL = 1e-5
# a max-pool pair that another route chose otherwise than the kernel route
# must be a tie up to f32 rounding: its gap at most this, of the row's largest
POOL_TIE_RTOL = 1e-5


def rel_gap(a, b) -> float:
    """max |a − b| over max |b|, for arrays or tensors, or dicts of them
    with equal keys (the largest over the keys)."""
    if isinstance(b, dict):
        if set(a) != set(b):
            fail(f"keys differ: {sorted(set(a) ^ set(b))}")
        return max(rel_gap(a[k], b[k]) for k in b)
    a, b = (np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)
            for x in (a, b))
    if a.shape != b.shape:
        fail(f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def on_cpu(tensors: dict) -> dict:
    return {k: v.cpu() for k, v in tensors.items()}


def explain_expected_launches(layers: int) -> dict:
    """K1-K3 launches of ``Explainer.explain`` with no target class, as the
    JAX package structures it: one probability forward; saliency,
    gradient×input and IG each recompute the target classes (a forward)
    and make one forward and one backward (IG's steps folded into the
    batch, so the count does not depend on them)."""
    return {"flash_fwd": layers * 7, "flash_bwd_dkv": layers * 3,
            "flash_bwd_dq": layers * 3}


def bridge_stage1(dev, card: str) -> dict:
    """Stage 1 as the JAX package's ``run_bridge_experiment`` trains it:
    TriModalFusionNetV4 at EEGConfig's widths (dropout 0.3: training takes
    the einsum route) on 66 subjects at T=512 and FMRIFusionNet at
    FMRIConfig's on 32, ``selection='train_loss'``, no eval set."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        EEGConfig,
        FMRIConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data.arrays import pad_rows
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
        synthetic_fmri,
    )
    from multimodal_eeg_fmri_tpu_torch.models.fmri import FMRIFusionNet
    from multimodal_eeg_fmri_tpu_torch.train.fit import make_fit_fn

    e, f = EEGConfig(), FMRIConfig()
    eeg = synthetic_eeg_trimodal(n_subjects=CV_EEG_N, time_steps=T_SERVE)
    fmri = synthetic_fmri(n_subjects=CV_FMRI_N)
    fmri.pop("reg_label")
    cfg = dataclasses.replace(TrainConfig(), num_epochs=STAGE1_EPOCHS,
                              selection="train_loss")

    def stage1(model, data):
        n = len(data["label"])
        train = pad_rows({k: v for k, v in data.items() if k != "subject"}, n)
        return make_fit_fn(model, cfg, eval_names=())(cfg.seed, train, {},
                                                      None)

    eeg_net = eeg_model(e, e.dropout, dev)
    fmri_net = FMRIFusionNet(hidden_dim=f.hidden_dim, dropout=f.dropout,
                             device=dev)
    (eeg_res, fmri_res), seconds = timed(lambda: (
        stage1(eeg_net, eeg), stage1(fmri_net, fmri)))
    losses = {k: r.history["train_loss"].cpu().numpy()
              for k, r in (("eeg", eeg_res), ("fmri", fmri_res))}
    print(f"stage 1: {STAGE1_EPOCHS} epochs of TriModalFusionNetV4 on "
          f"{CV_EEG_N} subjects at T={T_SERVE} and FMRIFusionNet on "
          f"{CV_FMRI_N} in {seconds:.2f} s {card}; train loss "
          + ", ".join(f"{k} {np.array2string(v, precision=4)}"
                      for k, v in losses.items()))
    if not all(np.all(np.isfinite(v)) for v in losses.values()):
        fail("stage 1: non-finite train loss")
    return dict(eeg=eeg, fmri=fmri, eeg_model=eeg_net, eeg_res=eeg_res,
                fmri_model=fmri_net, fmri_res=fmri_res, seconds=seconds)


def bridge_extract(s1: dict, card: str) -> dict:
    """Extraction (one eval forward of all 66 EEG subjects: K1 in the four
    temporal layers) and alignment; the gate holds the kernel route's EEG
    embeddings to the einsum route's and a CPU copy's."""
    from multimodal_eeg_fmri_tpu_torch.train.bridge_flow import (
        align_bridge_dataset,
        extract_fused_features,
    )

    eeg, fmri, res = s1["eeg"], s1["fmri"], s1["eeg_res"]
    model = s1["eeg_model"]
    layers = flash_layers(model, eeg)
    reset_all_launches()
    (eeg_subj, eeg_feats), seconds = timed(lambda: extract_fused_features(
        model, res.params, res.batch_stats, eeg))
    launches = total_launches()
    expected = {"flash_fwd": layers, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    print(f"extract_fused_features: {CV_EEG_N} subjects in one forward, "
          f"{1e3 * seconds:.3f} ms {card}; launches {launches} (expected "
          f"{expected})")
    if launches != expected:
        fail(f"extraction launched {launches}, expected {expected}")
    _, einsum_feats = extract_fused_features(
        einsum_route(copy.deepcopy(model)), res.params, res.batch_stats, eeg)
    _, cpu_feats = extract_fused_features(
        copy.deepcopy(model).cpu(), on_cpu(res.params),
        on_cpu(res.batch_stats), eeg)
    gaps = {"einsum": rel_gap(eeg_feats, einsum_feats),
            "cpu": rel_gap(eeg_feats, cpu_feats)}
    print(f"extraction gate: EEG embeddings, kernel route vs einsum route "
          f"{gaps['einsum']:.3e}, vs CPU {gaps['cpu']:.3e} of the largest "
          f"(limit {EXTRACT_RTOL:g})")
    if not all(g <= EXTRACT_RTOL for g in gaps.values()):
        fail("extraction: the kernel route's embeddings disagree")

    fmri_subj, fmri_feats = extract_fused_features(
        s1["fmri_model"], s1["fmri_res"].params, s1["fmri_res"].batch_stats,
        fmri)
    labels = {int(s): int(y) for s, y in zip(eeg["subject"], eeg["label"])}
    data = align_bridge_dataset(eeg_subj, eeg_feats, fmri_subj, fmri_feats,
                                labels)
    shapes = {k: v.shape for k, v in data.items()}
    print(f"aligned: {shapes}")
    if shapes != {"eeg": (CV_FMRI_N, 128), "fmri": (CV_FMRI_N, 64),
                  "label": (CV_FMRI_N,), "subject": (CV_FMRI_N,)}:
        fail(f"alignment gave {shapes}")
    return {"data": data, "launches": launches, "ms": 1e3 * seconds}


def fold_xai(model, cv, f: int, data: dict, dev) -> tuple:
    """Fold ``f``'s XAI by hand: saliency and IG of its held-out subject
    under the fold's best params, as ``run_bridge_loocv`` computes them."""
    from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
        gradient_saliency,
        integrated_gradients,
        make_apply_fn,
    )

    apply_fn = make_apply_fn(model, {k: v[f] for k, v in cv.params.items()},
                             {k: v[f] for k, v in cv.batch_stats.items()})
    inputs = {k: torch.as_tensor(data[k][f:f + 1], device=dev)
              for k in ("eeg", "fmri")}
    return (gradient_saliency(apply_fn, inputs),
            integrated_gradients(apply_fn, inputs, n_steps=BRIDGE_IG_STEPS))


def bridge_loocv(data: dict, dev, card: str) -> dict:
    """run_bridge_loocv at BridgeConfig's widths over 32 folds; its pooled
    metrics against a recomputation, two folds' XAI against a hand
    computation (bit for bit), and the records and clinical values."""
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        BridgeConfig,
        TrainConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.models.bridge import BridgeFusionNet
    from multimodal_eeg_fmri_tpu_torch.report.metrics import (
        binary_classification_metrics,
    )
    from multimodal_eeg_fmri_tpu_torch.train.bridge_flow import (
        run_bridge_loocv,
    )

    b = BridgeConfig()
    cfg = dataclasses.replace(TrainConfig(), learning_rate=1e-4,
                              weight_decay=1e-4, selection="train_loss",
                              num_epochs=BRIDGE_EPOCHS)
    reset_all_launches()
    res, seconds = timed(lambda: run_bridge_loocv(
        data, cfg, bridge_dim=b.bridge_dim, num_heads=b.num_heads,
        dropout=b.dropout, ig_steps=BRIDGE_IG_STEPS, device=dev))
    launches = total_launches()
    n = res.cv.n_folds
    print(f"run_bridge_loocv: {n} folds, {BRIDGE_EPOCHS} epochs, IG over "
          f"{BRIDGE_IG_STEPS} steps, in {seconds:.2f} s, {seconds / n:.3f} s "
          f"per fold {card}; pooled "
          + ", ".join(f"{k} {v:.4f}" for k, v in res.loocv_metrics.items())
          + f"; launches {launches} (the bridge's keys are 2 long: none)")
    if any(launches.values()):
        fail(f"the bridge LOOCV launched {launches}")

    real = res.cv.test_weight > 0
    probs, labels = res.cv.test_probs[real], res.cv.test_labels[real]
    again = {k: float(v) for k, v in binary_classification_metrics(
        torch.as_tensor(np.log(np.maximum(probs, 1e-9)), device=dev),
        torch.as_tensor(labels, device=dev)).items()}
    acc = float(np.mean(probs.argmax(-1) == labels))
    print(f"pooled metrics vs a recomputation from cv.test_probs: equal "
          f"{again == res.loocv_metrics}; accuracy by numpy {acc:.6f}")
    if again != res.loocv_metrics or abs(acc - again["accuracy"]) > 1e-6:
        fail("the pooled LOOCV metrics disagree with cv.test_probs")

    model = BridgeFusionNet(eeg_dim=128, fmri_dim=64,
                            bridge_dim=b.bridge_dim, num_heads=b.num_heads,
                            dropout=b.dropout, device=dev)
    xai_ms = []
    for f in (0, n - 1):
        (sal, ig), s = timed(lambda: fold_xai(model, res.cv, f, data, dev))
        xai_ms.append(1e3 * s)
        gap = max(
            float(np.abs(res.xai[f"{name}_{k}"][f] - a[k][0].cpu().numpy()
                         ).max())
            for name, a in (("saliency", sal), ("ig", ig))
            for k in ("eeg", "fmri"))
        print(f"fold {f}: per-fold XAI vs the attribution functions by hand "
              f"max|d| {gap:.3e} (limit 0); {xai_ms[-1]:.3f} ms by hand "
              f"{card}")
        if gap != 0:
            fail(f"fold {f}'s XAI differs from the hand computation")

    shapes = {k: v.shape for k, v in res.xai.items()}
    values = [v for r in res.per_subject for k, v in r.items()
              if k in ("prob_class1", "fusion_weights", "attn_weights")]
    print(f"records {len(res.per_subject)}, XAI {shapes}; clinical "
          + ", ".join(f"{k} {v:.4f}" for k, v in res.clinical.items()))
    if (len(res.per_subject) != n or n != CV_FMRI_N
            or shapes != {"saliency_eeg": (n, 128), "saliency_fmri": (n, 64),
                          "ig_eeg": (n, 128), "ig_fmri": (n, 64)}
            or not all(np.all(np.isfinite(v)) for v in values)
            or not all(np.all(np.isfinite(v)) for v in res.xai.values())
            or not all(math.isfinite(v) for v in res.clinical.values())):
        fail("bridge LOOCV: records, XAI shapes or clinical values")
    return {"result": res, "model": model, "seconds": seconds,
            "seconds_per_fold": seconds / n, "fold_xai_ms": xai_ms}


def attributions(model, params, stats, inputs: dict, targets, steps: int):
    """Saliency, gradient×input and IG over ``steps`` on ``model``'s route
    and device, for explicit target classes."""
    from multimodal_eeg_fmri_tpu_torch.xai.attribution import (
        gradient_saliency,
        gradient_x_input,
        integrated_gradients,
        make_apply_fn,
    )

    apply_fn = make_apply_fn(model, params, stats)
    t = targets.to(apply_fn.device)
    return {"saliency": gradient_saliency(apply_fn, inputs, t),
            "grad_x_input": gradient_x_input(apply_fn, inputs, t),
            "ig": integrated_gradients(apply_fn, inputs, t, n_steps=steps)}


@contextlib.contextmanager
def pooling_recorded(calls: list, pinned: list = None):
    """Record every ``max_pool_time`` call of the encoders as (|a − b| of
    each pooled pair over the row's largest |value|, the chosen indices),
    on the CPU; with ``pinned``, the recordings of another run, take their
    indices in call order instead of this run's own (the values still come
    from this run's input, and the gradient reaches the pinned element)."""
    from multimodal_eeg_fmri_tpu_torch.models import encoders

    real = encoders.max_pool_time
    given = iter(pinned or ())

    def pool(x, window=2):
        xt = x.transpose(1, 2)                            # (B, C, T)
        out, idx = torch.nn.functional.max_pool1d(xt, window,
                                                  return_indices=True)
        if pinned is not None:
            idx = next(given)[1].to(x.device)
            if idx.shape != out.shape:
                fail(f"pinned max-pool indices {tuple(idx.shape)} for an "
                     f"output {tuple(out.shape)}")
            out = xt.gather(-1, idx)
        pairs = xt[..., :out.shape[-1] * window].detach().unflatten(
            -1, (-1, window))
        top = x.detach().abs().flatten(1).amax(1).clamp_min(1e-30)
        gap = (pairs.amax(-1) - pairs.amin(-1)) / top[:, None, None]
        calls.append((gap.cpu(), idx.cpu()))
        return out.transpose(1, 2)

    encoders.max_pool_time = pool
    try:
        yield calls
    finally:
        encoders.max_pool_time = real


def print_pool_flips(what: str, mine: list, theirs: list) -> int:
    """Pooled pairs whose element another route chose otherwise than the
    kernel route, per ``max_pool_time`` call, with the largest relative gap
    between the pair's two values among them (on the kernel route); fails
    unless each is a tie up to POOL_TIE_RTOL; returns their count."""
    n = 0
    for call, ((gap, i_k), (_, i_o)) in enumerate(
            zip(mine, theirs, strict=True)):
        flipped = i_k != i_o
        k = int(flipped.sum())
        n += k
        most = gap[flipped].max().item() if k else 0.0
        print(f"{what}max-pool call {call}: {k} of {flipped.numel()} pairs "
              f"chosen otherwise (largest gap among them {most:.3e} of the "
              f"row's largest, limit {POOL_TIE_RTOL:g}; exact ties over all "
              f"pairs {int((gap == 0).sum())})")
        if most > POOL_TIE_RTOL:
            fail(f"{what}max-pool call {call} chose otherwise at a pair "
                 f"that is no tie")
    return n


def bridge_explain(s1: dict, card: str) -> dict:
    """Explainer.explain on the frozen EEG model at T=512: launches held to
    the counts derived from its structure at IG over 50 and 8 steps (α
    folded into the batch), its time and busy share; saliency,
    gradient×input and IG on the kernel route against the einsum route and
    a CPU copy, each with the kernel route's max-pool choices where it
    broke a tie otherwise."""
    from multimodal_eeg_fmri_tpu_torch.xai.explainer import Explainer

    model, res = s1["eeg_model"], s1["eeg_res"]
    inputs = {k: s1["eeg"][k][:XAI_ROWS] for k in EEG_KEYS}
    expected = explain_expected_launches(flash_layers(model, s1["eeg"]))
    out = {}
    for steps in (XAI_IG_STEPS, XAI_ROUTE_STEPS):
        explainer = Explainer(model, res.params, res.batch_stats,
                              ig_steps=steps)
        reset_all_launches()
        result = explainer.explain(inputs)    # counted; warms the shapes
        launches = total_launches()
        _, seconds = timed(lambda: explainer.explain(inputs))
        print(f"Explainer.explain, {XAI_ROWS} subjects, IG over {steps} steps "
              f"({steps * XAI_ROWS} rows): {1e3 * seconds:.3f} ms {card}; "
              f"launches {launches} (expected {expected})")
        if launches != expected:
            fail(f"explain at {steps} steps launched {launches}, expected "
                 f"{expected}")
        if not all(np.all(np.isfinite(v)) for a in (
                result.saliency, result.grad_x_input,
                result.integrated_gradients) for v in a.values()):
            fail("explain: non-finite attributions")
        out.setdefault("launches", launches)
        out[f"ms_ig{steps}"] = 1e3 * seconds
    explainer = Explainer(model, res.params, res.batch_stats,
                          ig_steps=XAI_IG_STEPS)
    out["busy"] = profile_calls(lambda: explainer.explain(inputs),
                                f"Explainer.explain, IG over {XAI_IG_STEPS} "
                                "steps", card, n=2)

    targets = torch.as_tensor(result.predictions)
    few = {k: v[:XAI_CPU_ROWS] for k, v in inputs.items()}
    # IG's α = 0 row is the zero baseline, where the ERP encoder's max-pool
    # sees exact ties in exact arithmetic; a conv that rounds position by
    # position breaks them its own way, and the gradient then reaches the
    # other element of a pair (O(1) on erp's attributions, which no
    # rounding limit can hold). A route that chose any pair otherwise is
    # printed and run again with the kernel route's choices, as the MoE
    # gates pin the router's.
    others = {"einsum": (einsum_route(copy.deepcopy(model)), res.params,
                         res.batch_stats, inputs),
              "cpu": (copy.deepcopy(model).cpu(), on_cpu(res.params),
                      on_cpu(res.batch_stats), few)}
    routes = {}
    for route, (m, params, stats, rows) in others.items():
        t = targets[:len(rows[EEG_KEYS[0]])]
        with pooling_recorded([]) as mine:
            ours = attributions(model, res.params, res.batch_stats, rows, t,
                                XAI_ROUTE_STEPS)
        with pooling_recorded([]) as theirs:
            other = attributions(m, params, stats, rows, t, XAI_ROUTE_STEPS)
        if print_pool_flips(f"attributions, kernel vs {route} route: ", mine,
                            theirs):
            with pooling_recorded([], pinned=mine):
                other = attributions(m, params, stats, rows, t,
                                     XAI_ROUTE_STEPS)
        routes[route] = (ours, other)
    for name in ("saliency", "grad_x_input", "ig"):
        gaps = {r: rel_gap(k[name], o[name]) for r, (k, o) in routes.items()}
        print(f"{name}, IG over {XAI_ROUTE_STEPS} steps: kernel route vs "
              f"einsum route ({XAI_ROWS} subjects) {gaps['einsum']:.3e}, vs "
              f"CPU ({XAI_CPU_ROWS}) {gaps['cpu']:.3e} of the largest (limit "
              f"{ATTR_RTOL:g})")
        if not all(g <= ATTR_RTOL for g in gaps.values()):
            fail(f"{name}: the kernel route disagrees")
    return out


def shap_case(model, params, stats, template: dict, X, background,
              n_samples: int) -> tuple:
    """Kernel SHAP of the class-1 probability on the model's device and on
    a CPU copy, the same coalitions (numpy, seed 0) on both: (Shapley
    values, card and CPU; the probabilities of every row the estimator
    evaluated, card and CPU; seconds on the card)."""
    from multimodal_eeg_fmri_tpu_torch.xai.shap_kernel import (
        kernel_shap,
        make_class_prob_fn,
    )

    def run(m, p, s):
        f, rows = make_class_prob_fn(m, p, s, template), []

        def recorded(x):
            rows.append(f(x))
            return rows[-1]

        phi = kernel_shap(recorded, X, background, n_samples=n_samples,
                          rng=np.random.default_rng(0))
        return phi, np.concatenate(rows)

    (phi, probs), seconds = timed(lambda: run(model, params, stats))
    phi_cpu, probs_cpu = run(copy.deepcopy(model).cpu(), on_cpu(params),
                             on_cpu(stats))
    return phi, phi_cpu, probs, probs_cpu, seconds


def bridge_shap(s1: dict, loocv: dict, data: dict, card: str) -> dict:
    """Kernel SHAP on the bridge (fold 0's class-1 probability, 32
    subjects, M = 192) and on the frozen EEG model (4 subjects, M =
    512·18 + 512·75 + 459, one batch of 4·64 coalition rows), card
    against CPU."""
    cv = loocv["result"].cv
    X = np.concatenate([data["eeg"], data["fmri"]], axis=1)
    phi, phi_cpu, probs, probs_cpu, bridge_s = shap_case(
        loocv["model"], {k: v[0] for k, v in cv.params.items()},
        {k: v[0] for k, v in cv.batch_stats.items()},
        {"eeg": (128,), "fmri": (64,)}, X, X, SHAP_BRIDGE_SAMPLES)
    gaps = (rel_gap(probs, probs_cpu), rel_gap(phi, phi_cpu))
    print(f"kernel SHAP, bridge fold 0: {X.shape[0]} subjects, M = "
          f"{X.shape[1]}, {SHAP_BRIDGE_SAMPLES} coalitions each, in "
          f"{bridge_s:.3f} s {card}; card vs CPU: probabilities of the "
          f"{len(probs)} rows {gaps[0]:.3e}, Shapley values {gaps[1]:.3e} "
          f"of the largest (limit {SHAP_RTOL:g})")
    if not (max(gaps) <= SHAP_RTOL and np.all(np.isfinite(phi))):
        fail("kernel SHAP on the bridge: card and CPU disagree")

    eeg, res = s1["eeg"], s1["eeg_res"]
    n = len(eeg["label"])
    flat = np.concatenate([eeg[k].reshape(n, -1) for k in EEG_KEYS], axis=1)
    template = {k: eeg[k].shape[1:] for k in EEG_KEYS}
    layers = flash_layers(s1["eeg_model"], eeg)
    reset_all_launches()
    phi, phi_cpu, probs, probs_cpu, eeg_s = shap_case(
        s1["eeg_model"], res.params, res.batch_stats, template,
        flat[:SHAP_EEG_ROWS], flat, SHAP_EEG_SAMPLES)
    launches = total_launches()
    # three calls on the card (the samples, the background, the coalition
    # rows), each one batch; the CPU copy launches nothing
    expected = {"flash_fwd": 3 * layers, "flash_bwd_dkv": 0,
                "flash_bwd_dq": 0}
    gaps = (rel_gap(probs, probs_cpu), rel_gap(phi, phi_cpu))
    print(f"kernel SHAP, frozen EEG model: {SHAP_EEG_ROWS} subjects, M = "
          f"{flat.shape[1]}, {SHAP_EEG_SAMPLES} coalitions each "
          f"({SHAP_EEG_ROWS * SHAP_EEG_SAMPLES} rows in one call), in "
          f"{eeg_s:.3f} s {card}; launches {launches} (expected {expected}); "
          f"card vs CPU: probabilities of the {len(probs)} rows "
          f"{gaps[0]:.3e} of the largest (limit {SHAP_RTOL:g}), Shapley "
          f"values {gaps[1]:.3e} (the estimator's amplification, not gated)")
    if launches != expected:
        fail(f"kernel SHAP on the EEG model launched {launches}")
    if not (gaps[0] <= SHAP_RTOL and np.all(np.isfinite(phi))):
        fail("kernel SHAP on the EEG model: card and CPU disagree")
    return {"bridge_seconds": bridge_s, "eeg_seconds": eeg_s,
            "launches": launches}


def bridge_phase(dev, card: str) -> dict:
    """The bridge phase: stage 1, extraction and alignment, the bridge
    LOOCV, the explainer at T=512 and Kernel SHAP. Only epoch counts are
    cut: stage 1 to 3 epochs and the bridge to 10, from 50 each."""
    print(f"cuts: stage-1 epochs 50 -> {STAGE1_EPOCHS}, bridge epochs 50 -> "
          f"{BRIDGE_EPOCHS}; widths, cohorts and IG steps are the JAX "
          "package's defaults")
    s1 = bridge_stage1(dev, card)
    phase("bridge-extract: extract_fused_features and align_bridge_dataset")
    extracted = bridge_extract(s1, card)
    data = extracted["data"]
    phase(f"bridge-loocv: run_bridge_loocv at BridgeConfig's widths, "
          f"{CV_FMRI_N} folds, {BRIDGE_EPOCHS} epochs")
    loocv = bridge_loocv(data, dev, card)
    phase(f"xai-explain-T{T_SERVE}: Explainer.explain on the frozen EEG model")
    explained = bridge_explain(s1, card)
    phase("xai-shap: kernel SHAP on the bridge and on the frozen EEG model")
    shap = bridge_shap(s1, loocv, data, card)
    print(json.dumps({"bridge": {
        "stage1_s": s1["seconds"], "extract_ms": extracted["ms"],
        "loocv_s": loocv["seconds"],
        "loocv_s_per_fold": loocv["seconds_per_fold"],
        "fold_xai_ms": loocv["fold_xai_ms"],
        "explain_ms_ig50": explained[f"ms_ig{XAI_IG_STEPS}"],
        "explain_ms_ig8": explained[f"ms_ig{XAI_ROUTE_STEPS}"],
        "explain_busy": explained["busy"],
        "shap_bridge_s": shap["bridge_seconds"],
        "shap_eeg_s": shap["eeg_seconds"], "device": card}}))
    return {"bridge-extract": extracted["launches"],
            f"xai-explain-T{T_SERVE}": explained["launches"],
            "xai-shap-eeg": shap["launches"]}


# --- the serving slice ----------------------------------------------------
SERVE_MEMBERS = 5                 # the 5-fold protocol's fold models
SERVE_EPOCHS = 6                  # member 0's fit on a separable cohort
SERVE_ATOL = 1e-5                 # ensemble vs a host loop, of the largest
EXPORT_ATOL = 1e-6                # exported program vs the live predictor
# tests/test_quantize.py:107,167: drift of the served probabilities
QUANT_DRIFT = {8: 0.05, 4: 0.15}
QUANT_MIN_RATIO = 3.0             # f32 bytes over the int8 payload's
BATCHER_ROWS, QUEUE_BURST, MAX_QUEUE = 32, 32, 4
# tests/test_drift.py:69-91: a 2σ shift alarms within 30 samples
DRIFT_FEATURES, DRIFT_NULL, DRIFT_SHIFTED, DRIFT_DELAY = 8, 150, 60, 30
WAIT_S = 60.0                     # any thread's longest wait


def separable(n: int, T: int, seed: int) -> dict:
    """``request`` rows with labels half of each class and every modality
    shifted by ±1 with its class, so that a short fit learns them."""
    data = request(n, T, seed)
    label = np.arange(n) % 2
    sign = (2.0 * label - 1.0).astype(np.float32)
    data = {k: v + sign.reshape((n,) + (1,) * (v.ndim - 1))
            for k, v in data.items()}
    data["label"] = label.astype(np.int64)
    data["weight"] = np.ones(n, np.float32)
    return data


def serve_members(dev) -> list:
    """Five full-width members from five seeds; member 0 trained
    ``SERVE_EPOCHS`` epochs on a separable cohort, so that its decisions hold a margin for the
    quantized payloads' argmax gate."""
    from multimodal_eeg_fmri_tpu_torch import (
        MultimodalEndToEnd,
        TrainConfig,
        init_weights,
        make_fit_fn,
    )

    members = [init_weights(MultimodalEndToEnd(device=dev),
                            torch.Generator().manual_seed(100 + k))
               for k in range(SERVE_MEMBERS)]
    cohort, val = ({k: torch.as_tensor(v, device=dev) for k, v in
                    separable(n, T_SERVE, seed=seed).items()}
                   for n, seed in ((32, 40), (16, 41)))
    make_fit_fn(members[0], TrainConfig(batch_size=BATCH,
                                        num_epochs=SERVE_EPOCHS,
                                        learning_rate=1e-3),
                eval_names=("val",))(0, cohort, {"val": val},
                                     torch.ones(2, device=dev))
    return members


def serve_gate_ensemble(members, rows: dict, card: str) -> dict:
    """Gate b: each reduction against a host loop of K ``Predictor``s, and
    K1's launches per served batch."""
    from multimodal_eeg_fmri_tpu_torch import Predictor
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        reset_kernel_launches,
    )
    from multimodal_eeg_fmri_tpu_torch.serving import EnsemblePredictor

    loop = np.stack([Predictor(m, BATCH)(**rows) for m in members])
    votes = np.eye(loop.shape[-1], dtype=np.float32)[loop.argmax(-1)]
    want = {"mean_probs": loop.mean(0), "vote": votes.mean(0), "none": loop}
    ensembles, errs = {}, {}
    for reduce, expect in want.items():
        ens = EnsemblePredictor.from_modules(members, batch_size=BATCH,
                                             reduce=reduce)
        reset_kernel_launches()
        got = ens(**rows)
        torch.cuda.synchronize()
        launches = total_launches()
        if launches != {"flash_fwd": 4, "flash_bwd_dkv": 0,
                        "flash_bwd_dq": 0}:
            fail(f"EnsemblePredictor({SERVE_MEMBERS}, {reduce}) launched "
                 f"{launches} for one batch; expected 4 flash_fwd (the "
                 "member axis folded into each launch)")
        errs[reduce] = float(np.abs(got - expect).max())
        limit = 0.0 if reduce == "vote" else SERVE_ATOL * np.abs(
            expect).max()
        if got.shape != expect.shape or not errs[reduce] <= limit:
            fail(f"ensemble {reduce}: shape {got.shape}, max|d| "
                 f"{errs[reduce]:.3e} against the host loop (limit "
                 f"{limit:.1e})")
        ensembles[reduce] = ens
    print(f"gate b: EnsemblePredictor(K={SERVE_MEMBERS}) vs a loop of "
          f"{SERVE_MEMBERS} Predictors, max|d| {errs} (limit {SERVE_ATOL:g} "
          f"of the largest, votes exact); 4 flash_fwd launches per batch, "
          f"not {4 * SERVE_MEMBERS}")
    return ensembles


def serve_gate_folded_k1(dev, card: str) -> dict:
    """K1 reached through vmap over the members at the ensemble's shape:
    one launch on the folded (K·B, 4, 512, 32) batch, held against the
    plain version there; its times beside its bound and SDPA's."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_attention_lse,
        flash_forward_cuda,
        flash_forward_plain,
        reset_kernel_launches,
    )

    gen = torch.Generator(device=dev).manual_seed(7)
    K, H, d = SERVE_MEMBERS, 4, 32
    q, k, v = (torch.randn(K, BATCH, H, T_SERVE, d, device=dev,
                           generator=gen) for _ in range(3))
    reset_kernel_launches()
    with torch.inference_mode():
        out, lse = torch.func.vmap(flash_attention_lse)(q, k, v)
    torch.cuda.synchronize()
    if total_launches()["flash_fwd"] != 1:
        fail(f"vmap over {K} members launched K1 {total_launches()} times")
    folded = [t.reshape(K * BATCH, H, T_SERVE, d) for t in (q, k, v)]
    out_p, lse_p = flash_forward_plain(*folded)
    err = max(float((out.reshape(out_p.shape) - out_p).abs().max()),
              float((lse.reshape(lse_p.shape) - lse_p).abs().max()))
    shape = (K * BATCH, H, T_SERVE, d)
    print(f"K1 under vmap on the folded {shape}: max|d| {err:.3e} against "
          f"flash_forward_plain (limit {KERNEL_ATOL:g})")
    if not err <= KERNEL_ATOL:
        fail("K1 on the folded ensemble batch disagrees with its plain "
             "version")
    ms, plain_ms = in_turns(lambda: cuda_ms(lambda: flash_forward_cuda(
        *folded)), lambda: cuda_ms(lambda: flash_forward_plain(*folded)))
    dev_ms = device_ms(lambda: flash_forward_cuda(*folded))
    lib_ms = cuda_ms(lambda: sdpa(*folded))
    b_ms, by = bound_ms("flash_fwd", K * BATCH, H, T_SERVE, T_SERVE, d)
    print(f"flash_fwd {shape} f32: kernel {ms:.4f} ms (device "
          f"{_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({by}), library (SDPA forward) {lib_ms:.4f} ms per call {card}")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib_ms}


def serve_dispatch_cost(dev, card: str) -> dict:
    """What reaching K1-K3 through the operators costs the host, at the
    serving shape (8, 4, 512, 32), where a call is host-bound: wall time
    per call (CUDA events around the calls) of ``flash_attention`` against
    the wrapper ``flash_forward_cuda`` itself, in inference; and a forward
    and backward through autograd, by the port's route (the operators
    inside ``_FlashAttention``) against the same autograd wiring calling the
    wrappers directly, as before the operators, and against K1, K2 and K3
    called by hand."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward_cuda,
        flash_forward_cuda,
    )

    class Wrappers(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = flash_forward_cuda(q, k, v)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            return flash_backward_cuda(q, k, v, out, lse, g.contiguous())

    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, g = (torch.randn(BATCH, 4, T_SERVE, 32, device=dev,
                              generator=gen) for _ in range(4))
    with torch.inference_mode():
        op_ms, wrapper_ms = in_turns(
            lambda: cuda_ms(lambda: flash_attention(q, k, v), iters=500),
            lambda: cuda_ms(lambda: flash_forward_cuda(q, k, v), iters=500))
    qg = q.clone().requires_grad_()

    def by_hand():
        out, lse = flash_forward_cuda(q, k, v)
        flash_backward_cuda(q, k, v, out, lse, g)

    ops_ms, wired_ms = in_turns(
        lambda: cuda_ms(lambda: torch.autograd.backward(
            flash_attention(qg, k, v), g)),
        lambda: cuda_ms(lambda: torch.autograd.backward(
            Wrappers.apply(qg, k, v), g)))
    hand_ms = cuda_ms(by_hand)
    print(f"K1 through the operator, (8, 4, 512, 32), inference: "
          f"{op_ms:.4f} ms a call, the wrapper alone {wrapper_ms:.4f} ms; "
          f"forward and backward through autograd: the operators "
          f"{ops_ms:.4f} ms, the wrappers {wired_ms:.4f} ms, K1+K2+K3 by "
          f"hand {hand_ms:.4f} ms {card}")
    return {"op_call_ms": op_ms, "wrapper_call_ms": wrapper_ms,
            "autograd_ops_fwd_bwd_ms": ops_ms,
            "autograd_wrappers_fwd_bwd_ms": wired_ms,
            "kernels_by_hand_fwd_bwd_ms": hand_ms}


def serve_gate_exports(live, ensemble, rows: dict, tmp: Path) -> None:
    """Gate c: each exported program, loaded again, equals its live
    predictor and launches K1 inside its own call."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        reset_kernel_launches,
    )
    from multimodal_eeg_fmri_tpu_torch.serving import load_artifact

    for name, served in (("Predictor", live), ("EnsemblePredictor",
                                               ensemble)):
        path = tmp / f"{name}.pt2"
        size = len(served.export_artifact(rows, path))
        fn = load_artifact(path)
        want = served(**rows)
        reset_kernel_launches()
        got = fn(**rows)
        torch.cuda.synchronize()
        n = total_launches()["flash_fwd"]
        err = float(np.abs(got - want).max())
        print(f"gate c: exported {name} ({size} bytes), loaded again: "
              f"max|d| {err:.3e} (limit {EXPORT_ATOL:g}), {n} flash_fwd "
              "launches inside its call")
        if not (err <= EXPORT_ATOL and n == 4):
            fail(f"the exported {name} disagrees or did not launch K1")


def serve_gate_quantized(dev, model, val: dict, tmp: Path) -> None:
    """Gate d: int8 and int4 payloads of the card model, written by the
    port, served on the card within the JAX tests' drift bounds with the
    same decisions; the int8 payload over 3× smaller than f32."""
    from multimodal_eeg_fmri_tpu_torch import MultimodalEndToEnd, Predictor
    from multimodal_eeg_fmri_tpu_torch.convert import (
        flax_variables_from_module,
    )
    from multimodal_eeg_fmri_tpu_torch.core.quantize import save_quantized

    variables = flax_variables_from_module(model)
    f32_bytes = sum(a.nbytes for tree in variables.values()
                    for a in _leaves(tree))
    ref = Predictor(model, BATCH)(**val)
    for bits in (8, 4):
        path = save_quantized(tmp / f"int{bits}", variables, bits=bits)
        served = Predictor.from_quantized(MultimodalEndToEnd(device=dev),
                                          path, batch_size=BATCH)
        if served.device != next(model.parameters()).device:
            fail("the quantized predictor is not on the card")
        got = served(**val)
        drift = float(np.abs(got - ref).max())
        same = bool(np.array_equal(got.argmax(-1), ref.argmax(-1)))
        ratio = f32_bytes / path.stat().st_size
        print(f"gate d: int{bits} payload {path.stat().st_size} bytes "
              f"({ratio:.2f}x smaller than f32), served on the card: "
              f"max|d| {drift:.3e} (limit {QUANT_DRIFT[bits]}), same "
              f"decisions {same}; f32 margins: min |p1-p0| "
              f"{np.abs(ref[:, 1] - ref[:, 0]).min():.3f}")
        if not (drift < QUANT_DRIFT[bits] and same):
            fail(f"the int{bits} payload drifts past its bound or flips a "
                 "decision")
        if bits == 8 and not ratio > QUANT_MIN_RATIO:
            fail(f"the int8 payload is only {ratio:.2f}x smaller than f32")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def serve_gate_calibrated(live, val: dict) -> float:
    """Gate e: a finite T > 0 and the calibrated forward softmax(z/T)."""
    from multimodal_eeg_fmri_tpu_torch import Predictor

    cal = live.calibrated(val, val["label"])
    t = cal.temperature
    logits = Predictor(live.model, BATCH, return_probs=False)(**val)
    want = torch.softmax(torch.from_numpy(logits) / t, -1).numpy()
    err = float(np.abs(cal(**val) - want).max())
    print(f"gate e: calibrated T = {t:.6f}; forward vs softmax(z/T): max|d| "
          f"{err:.3e} (limit {EXPORT_ATOL:g})")
    if not (math.isfinite(t) and t > 0 and err <= EXPORT_ATOL):
        fail("calibration gave a bad temperature or forward")
    return t


def _threads(fn, n: int) -> None:
    """Run ``fn(i)`` on ``n`` threads and raise the first exception any of
    them raised once all have joined (or hung past ``WAIT_S``)."""
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        if t.is_alive():
            fail("a request thread hung")
    if errors:
        raise errors[0]


def serve_gate_batcher(live, card: str) -> float:
    """Gate f: 32 one-row requests from 32 threads equal the direct call
    in fewer calls than rows; a burst past ``max_queue`` gets
    ``QueueFull``; ``close()`` drains what was accepted."""
    from multimodal_eeg_fmri_tpu_torch.serving import (
        DynamicBatcher,
        QueueFull,
    )

    rows = request(BATCHER_ROWS, T_SERVE, seed=60)
    direct = live(**rows)
    out = {}

    def one(b, i):
        out[i] = b(**{k: v[i:i + 1] for k, v in rows.items()})

    with DynamicBatcher(live, max_delay_ms=5.0, max_batch=BATCH,
                        timeout_s=WAIT_S) as b:
        t0 = time.perf_counter()
        _threads(lambda i: one(b, i), BATCHER_ROWS)
        rows_per_s = BATCHER_ROWS / (time.perf_counter() - t0)
        batches = b.batches
    if not all(np.array_equal(out[i], direct[i:i + 1])
               for i in range(BATCHER_ROWS)):
        fail("a batched row differs from the direct call")
    print(f"gate f: {BATCHER_ROWS} threads, one row each: rows equal the "
          f"direct call; {batches} calls, {BATCHER_ROWS / batches:.2f} rows "
          f"per call; {rows_per_s:.1f} rows/s {card}")
    if not batches < BATCHER_ROWS:
        fail("the batcher coalesced nothing")

    # a burst while the first call is held: the queue takes MAX_QUEUE rows
    release = threading.Event()

    def held(**inputs):
        release.wait(WAIT_S)
        return live(**inputs)

    served, rejected = {}, []
    b = DynamicBatcher(held, max_delay_ms=1.0, max_batch=4,
                       max_queue=MAX_QUEUE, timeout_s=WAIT_S)

    def burst(i):
        try:
            served[i] = b(**{k: v[i:i + 1] for k, v in rows.items()})
        except QueueFull:
            rejected.append(i)

    threads = [threading.Thread(target=burst, args=(i,))
               for i in range(QUEUE_BURST)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + WAIT_S
    while (len(rejected) < QUEUE_BURST - 4 - MAX_QUEUE
           and time.monotonic() < deadline):
        time.sleep(0.01)
    release.set()
    b.close()   # drains the accepted requests
    for t in threads:
        t.join(WAIT_S)
        if t.is_alive():
            fail("a burst thread hung")
    print(f"burst of {QUEUE_BURST} against max_queue={MAX_QUEUE}: "
          f"{len(rejected)} QueueFull, {len(served)} served after close()")
    if not (rejected and b.rejected == len(rejected)
            and len(served) + len(rejected) == QUEUE_BURST and all(
                np.array_equal(v, direct[i:i + 1])
                for i, v in served.items())):
        fail("backpressure or the drain on close() misbehaved")
    return rows_per_s


def serve_gate_monitoring(dev, ensemble_none, rows: dict) -> None:
    """Gate g: the members' uncertainty from the card's outputs, and a
    drift monitor on the card over a replayed stream with a 2σ shift on
    one feature."""
    from multimodal_eeg_fmri_tpu_torch.report.drift import (
        make_drift_monitor,
    )
    from multimodal_eeg_fmri_tpu_torch.report.uncertainty import (
        ensemble_uncertainty,
    )

    members = torch.as_tensor(ensemble_none(**rows), device=dev)
    unc = ensemble_uncertainty(members)
    if not all(bool(torch.isfinite(v).all()) for v in unc.values()) or bool(
            (unc["mutual_information"] < 0).any()):
        fail(f"uncertainty not finite or BALD < 0: {unc}")
    r = np.random.default_rng(70)
    ref = r.standard_normal((5000, DRIFT_FEATURES)).astype(np.float32)
    stream = r.standard_normal((DRIFT_NULL + DRIFT_SHIFTED,
                                DRIFT_FEATURES)).astype(np.float32)
    stream[DRIFT_NULL:, 3] += 2.0
    init, step = make_drift_monitor(torch.as_tensor(ref.mean(0), device=dev),
                                    ref.std(0), k=0.5, h=8.0)
    state, alarms = init(), []
    for x in torch.as_tensor(stream, device=dev):
        state, out = step(state, x)
        alarms.append(out["per_feature"])
    alarms = torch.stack(alarms).cpu().numpy()
    hits = np.nonzero(alarms[DRIFT_NULL:].any(-1))[0]
    delay = int(hits[0]) if len(hits) else DRIFT_NULL + DRIFT_SHIFTED
    named = (np.nonzero(alarms[DRIFT_NULL + delay])[0].tolist()
             if len(hits) else [])
    print(f"gate g: BALD {unc['mutual_information'].cpu().numpy().round(5)}"
          f", disagreement {unc['disagreement'].cpu().numpy()}; drift on "
          f"{state.n.device}: {int(alarms[:DRIFT_NULL].sum())} alarms before "
          f"the shift, the first after it in {delay} samples (limit "
          f"{DRIFT_DELAY}) naming features {named}")
    if alarms[:DRIFT_NULL].any() or delay >= DRIFT_DELAY or named != [3]:
        fail("the drift monitor missed the shift or named another feature")


def serve_timings(live, members, ensemble, rows: dict, card: str) -> dict:
    """p50/p95 of a batch of 8 for the Predictor, the ensemble, and the
    sequential loop of five Predictors; the profiler's busy share for one
    ensemble batch."""
    from multimodal_eeg_fmri_tpu_torch import Predictor

    single = live.benchmark(rows, warmup=5, iters=30)
    ens = ensemble.benchmark(rows, warmup=5, iters=30)
    preds = [Predictor(m, BATCH) for m in members]
    dev_rows = live._to_device({k: v[:BATCH] for k, v in rows.items()})

    def loop():
        for p in preds:
            p._forward(dev_rows)
        torch.cuda.synchronize()

    for _ in range(5):
        loop()
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        loop()
        times.append((time.perf_counter() - t0) * 1000.0)
    loop_p50 = float(np.percentile(times, 50))
    print(f"Predictor B={BATCH} T={T_SERVE}: p50 {single['p50_ms']:.3f} ms, "
          f"p95 {single['p95_ms']:.3f} ms {card}")
    print(f"EnsemblePredictor(K={SERVE_MEMBERS}) B={BATCH} T={T_SERVE}: p50 "
          f"{ens['p50_ms']:.3f} ms, p95 {ens['p95_ms']:.3f} ms; a loop of "
          f"{SERVE_MEMBERS} Predictors: p50 {loop_p50:.3f} ms {card}")
    busy = profile_calls(lambda: ensemble._forward(dev_rows),
                         f"one EnsemblePredictor(K={SERVE_MEMBERS}) batch",
                         card)
    return {"predictor_p50_ms": single["p50_ms"],
            "predictor_p95_ms": single["p95_ms"],
            "ensemble_p50_ms": ens["p50_ms"], "ensemble_p95_ms": ens["p95_ms"],
            "member_loop_p50_ms": loop_p50, "ensemble_busy_share": busy}


def serving_phase(dev, card: str) -> dict:
    """The serving phase: gates a-g; returns K1's launches per ensemble
    batch, its folded-shape timings and the phase's times."""
    from multimodal_eeg_fmri_tpu_torch import MultimodalEndToEnd, Predictor
    from multimodal_eeg_fmri_tpu_torch.core.checkpoint import save_checkpoint

    t0 = time.perf_counter()

    def lap(what: str) -> None:
        print(f"  {what} done at {time.perf_counter() - t0:.1f} s of the "
              "phase", flush=True)

    members = serve_members(dev)
    lap("members")
    rows = request(BATCH, T_SERVE, seed=50)
    val = separable(16, T_SERVE, seed=41)
    live = Predictor(members[0], BATCH)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        params = {k: p.detach() for k, p in members[0].named_parameters()}
        stats = {k: v for k, v in members[0].state_dict().items()
                 if k not in params}
        save_checkpoint(tmp / "ck", params, batch_stats=stats)
        loaded = Predictor.from_checkpoint(MultimodalEndToEnd(device=dev),
                                           tmp / "ck", batch_size=BATCH)
        same = np.array_equal(loaded(**rows), live(**rows))
        print(f"gate a: Predictor.from_checkpoint equals the live predictor "
              f"bit for bit: {same}")
        if not same:
            fail("the checkpoint round trip changed the served output")
        ensembles = serve_gate_ensemble(members, rows, card)
        lap("gates a, b")
        folded = serve_gate_folded_k1(dev, card)
        dispatch = serve_dispatch_cost(dev, card)
        lap("K1 folded, dispatch cost")
        serve_gate_exports(live, ensembles["mean_probs"], rows, tmp)
        lap("gate c")
        serve_gate_quantized(dev, members[0], val, tmp)
        lap("gate d")
    temperature = serve_gate_calibrated(live, val)
    rows_per_s = serve_gate_batcher(live, card)
    serve_gate_monitoring(dev, ensembles["none"], rows)
    lap("gates e, f, g")
    times = serve_timings(live, members, ensembles["mean_probs"], rows, card)
    seconds = time.perf_counter() - t0
    print(f"serving phase: {seconds:.1f} s {card}")
    return {"launches_per_batch": 4, "folded": folded,
            "times": {**times, **dispatch, "batcher_rows_per_s": rows_per_s,
                      "calibrated_temperature": temperature,
                      "phase_s": seconds}}


# ---------------------------------------------------------------------------
# The pipelines phase: pipelines.py, __main__.py, train/hpo.py and the
# file loaders, on the card
# ---------------------------------------------------------------------------

PIPE_T = 512                       # 2-second epochs: K1 in the temporal layers
PIPE_EPOCHS = 1                    # cut from TrainConfig's 50
PIPE_GOOD, PIPE_POOR, PIPE_NAN = 35, 31, 3   # outcomes; rows with no score
PIPE_BANDS = ("delta", "theta", "alpha", "beta", "gamma")
FMRI_TYPES = ("sensory", "AN", "LN", "cognitive", "DMN")
FMRI_ROWS, FMRI_ROIS, FMRI_CONN = 20, 9, 8
HPO_TRIALS, HPO_TOP = 16, 0.25
HPO_TRAIN, HPO_VAL = 50, 16        # of 66 synthetic subjects
PADDED_DIMS = (8, 12, 24, 48)      # head dims between the kernel instances
PADDED_SHAPES = [(2, 2, 300, 333, d) for d in PADDED_DIMS]
PAD_TIMING_SHAPE = (8, 4, 512, 24)  # hidden 96 over 4 heads at T=512


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` set to ``value`` while the block runs."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def write_cohort(root: Path, cfg) -> dict:
    """A cohort in the reference's file formats, with scipy and numpy only:
    ``medical_score.csv`` (66 EEG subjects, 35 good and 31 poor outcomes,
    and subjects with no score), the five bands' classic .mat conn, PW and
    ERP files (ERP 18 channels, PW 75 rows, CONN 3 × 153 = 459, T = 512),
    32 fMRI subjects' activation and connectivity CSVs and
    ``DATA/labels/labels.csv``. Returns the file counts."""
    from scipy.io import savemat

    r = np.random.default_rng(60)
    eeg, fmri = root / "eeg", root / "fmri"
    for d in ("conn", "pw", "erp"):
        (eeg / d).mkdir(parents=True)
    n = PIPE_GOOD + PIPE_POOR
    scores = np.concatenate([r.integers(1, 3, PIPE_GOOD),
                             r.integers(3, 6, PIPE_POOR)])
    r.shuffle(scores)
    with open(eeg / "medical_score.csv", "w") as f:
        f.write("Subject,Postoperative evaluation\n")
        for s in range(1, n + PIPE_NAN + 1):
            f.write(f"sub{s:02d},{scores[s - 1] if s <= n else ''}\n")
    files = 0
    for s in range(1, n + 1):
        sign = 1.0 if scores[s - 1] > 2 else -1.0    # a class signal
        for band, (lo, hi) in cfg.eeg.freq_bands.items():
            freq = f"{int(lo)}_{int(hi)}_Hz"
            for cond in ("open", "close"):
                savemat(eeg / "conn" / f"conn_{band.capitalize()}_{cond}_"
                        f"sub{s:02d}.mat", {"conn": (
                            r.standard_normal((3, 153)) + 0.3 * sign
                        ).astype(np.float32)})
            savemat(eeg / "pw" / f"powspctrm_{band}_{freq}_sub{s:02d}.mat",
                    {"powspctrm": (r.standard_normal((75, PIPE_T))
                                   + 0.3 * sign).astype(np.float32)})
            savemat(eeg / "erp" / f"ERP_sub{s:02d}_{band}_{freq}.mat",
                    {"erp": (r.standard_normal((18, PIPE_T))
                             + 0.3 * sign).astype(np.float32)})
            files += 4
    for s in cfg.fmri.subjects:
        d = fmri / f"sub-{s}"
        d.mkdir(parents=True)
        for kind in FMRI_TYPES:
            np.savetxt(d / f"subject_{s}_activation_{kind}.csv",
                       r.standard_normal((FMRI_ROWS, FMRI_ROIS)),
                       delimiter=",", comments="",
                       header=",".join(map(str, range(FMRI_ROIS))))
        np.savetxt(d / f"subject_{s}_fdr_PPI_Connectivity_DMN.csv",
                   r.standard_normal((FMRI_CONN, FMRI_CONN)), delimiter=",",
                   comments="", header=",".join(map(str, range(FMRI_CONN))))
        files += len(FMRI_TYPES) + 1
    (fmri / "DATA" / "labels").mkdir(parents=True)
    with open(fmri / "DATA" / "labels" / "labels.csv", "w") as f:
        f.write("Subject,Label,Score\n")
        for s in cfg.fmri.subjects:
            f.write(f"{s},{s % 2},{r.standard_normal():.6f}\n")
    return {"eeg_subjects": n, "fmri_subjects": len(cfg.fmri.subjects),
            "files": files + 2}


def pipeline_expected(cfg, dev) -> dict:
    """K1 launches each pipeline must make, from the flash layers of the
    models it builds (an eval forward of two rows at T=512), its folds and
    evaluations: the transformer models train with attention dropout on
    (the einsum route), so K1 runs only in evaluations, per fold
    ``layers × (2 eval sets × epochs + 1 test evaluation)``; the LOSO run
    has a fold per subject; the bridge's extraction is one forward of all
    subjects; the fMRI models have no attention. No K2 or K3."""
    from multimodal_eeg_fmri_tpu_torch import pipelines

    data = pipelines.load_or_synthesize_eeg(cfg)
    per_fold = 2 * PIPE_EPOCHS + 1
    layers = {name: flash_layers(m, data) for name, m in
              pipelines.eeg_models(cfg, data, dev).items()}
    eeg = sum(cfg.eeg.n_splits * n * per_fold for n in layers.values())
    eeg += len(data["label"]) * layers["trimodal"] * per_fold   # LOSO
    lite = cfg.eeg.n_splits * flash_layers(
        pipelines.lite_model(cfg, data, dev), data) * per_fold
    zero = {"flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    return {"eeg": {"flash_fwd": eeg, **zero},
            "fmri": {"flash_fwd": 0, **zero},
            "bridge": {"flash_fwd": layers["trimodal"], **zero},
            "lite": {"flash_fwd": lite, **zero}, "layers": layers}


def pipelines_all_phase(dev, card: str) -> dict:
    """pipelines-all-T512: ``python -m multimodal_eeg_fmri_tpu_torch
    --pipeline all`` in process (``__main__.main``) with a JSON config at
    EEGConfig's full widths and T=512, data roots on a cohort written in the
    reference's file formats, one epoch, exports to a temp dir. Each
    pipeline is timed and its launches held to ``pipeline_expected``; the
    file ingest is timed and its path printed; the exports must exist."""
    from multimodal_eeg_fmri_tpu_torch import __main__ as cli
    from multimodal_eeg_fmri_tpu_torch import pipelines
    from multimodal_eeg_fmri_tpu_torch.core.config import (
        EEGConfig,
        ExperimentConfig,
        FMRIConfig,
    )
    from multimodal_eeg_fmri_tpu_torch.data import native_io

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cfg = ExperimentConfig(
            eeg=EEGConfig(data_root=str(tmp / "eeg"), time_steps=PIPE_T),
            fmri=FMRIConfig(data_root=str(tmp / "fmri")),
            output_dir=str(tmp / "results"))
        counts, write_s = timed(lambda: write_cohort(tmp, cfg))
        print(f"cohort: {counts} written in {write_s:.2f} s")
        (tmp / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))

        expected = pipeline_expected(cfg, dev)
        ingest = {"eeg": [], "fmri": []}
        results = {}

        def timed_load(kind, load):
            def wrapper(c):
                data, s = timed(lambda: load(c))
                ingest[kind].append(s)
                return data
            return wrapper

        def timed_run(pipe, run):
            def wrapper(*a, **kw):
                reset_all_launches()
                out, s = timed(lambda: run(*a, **kw))
                results[pipe] = {"s": s, "launches": total_launches(),
                                 "out": out}
                return out
            return wrapper

        with contextlib.ExitStack() as stack:
            for name, wrap in (
                    ("load_or_synthesize_eeg", functools.partial(
                        timed_load, "eeg")),
                    ("load_or_synthesize_fmri", functools.partial(
                        timed_load, "fmri")),
                    ("run_eeg_experiment", functools.partial(
                        timed_run, "eeg")),
                    ("run_fmri_experiment", functools.partial(
                        timed_run, "fmri")),
                    ("run_bridge_experiment", functools.partial(
                        timed_run, "bridge")),
                    ("run_lite_training", functools.partial(
                        timed_run, "lite"))):
                stack.enter_context(patched(pipelines, name,
                                            wrap(getattr(pipelines, name))))
            rc = cli.main(["--pipeline", "all", "--config",
                           str(tmp / "cfg.json"), "--epochs",
                           str(PIPE_EPOCHS)])
        exports = sorted(re.sub(r"_\d+(\.\w+)$", r"\1", p.name)
                         for p in (tmp / "results").iterdir())
    path = "native" if native_io.native_available() else "numpy"
    print(f"ingest path: {path}; EEG ingest {ingest['eeg']} s, fMRI ingest "
          f"{ingest['fmri']} s {card}")
    print(f"flash layers at T={PIPE_T}: {expected['layers']}")
    for pipe, res in results.items():
        print(f"pipelines-all-T{PIPE_T} {pipe}: {res['s']:.2f} s {card}; "
              f"launches {res['launches']} (expected {expected[pipe]})")
    if rc != 0 or set(results) != {"eeg", "fmri", "bridge", "lite"}:
        fail(f"the CLI returned {rc} after {sorted(results)}")
    bad = {p: r["launches"] for p, r in results.items()
           if r["launches"] != expected[p]}
    if bad:
        fail(f"pipelines launched {bad}, expected "
             f"{ {p: expected[p] for p in bad} }")
    eeg_out = results["eeg"]["out"]
    print("headline: eeg trimodal f1 {:.4f} ± {:.4f}, LOSO subject accuracy "
          "{:.4f}; fmri fusion accuracy {:.4f} ± {:.4f}; bridge LOOCV "
          "accuracy {:.4f}; lite f1 {:.4f} ± {:.4f}".format(
              *eeg_out["kfold"]["trimodal"].summary["f1"],
              eeg_out["loso"]["subject_accuracy"],
              *results["fmri"]["out"]["classification"]["fusion"]
              .summary["accuracy"],
              results["bridge"]["out"]["bridge"].loocv_metrics["accuracy"],
              *results["lite"]["out"]["lite"].summary["f1"]))
    want = ["bridge_subjects.csv", "bridge_xai.npz", "eeg_detailed.csv",
            "eeg_summary.csv", "fmri_detailed.csv", "fmri_summary.csv",
            "lite_detailed.csv", "lite_summary.csv"]
    print(f"exports: {exports}")
    if exports != want:
        fail(f"exports {exports}, expected {want}")
    finite = [np.all(np.isfinite(r.fold_metrics[k]))
              for out in (eeg_out["kfold"],
                          results["fmri"]["out"]["classification"],
                          {"lite": results["lite"]["out"]["lite"]})
              for r in out.values() for k in r.fold_metrics]
    if not all(finite) or not np.isfinite(
            results["bridge"]["out"]["bridge"].loocv_metrics["accuracy"]):
        fail("a pipeline gave non-finite metrics")
    return {"seconds": {p: r["s"] for p, r in results.items()},
            "ingest_s": ingest, "ingest_path": path,
            "launches": {p: r["launches"] for p, r in results.items()},
            "cohort_write_s": write_s}


def hpo_phase(dev, card: str) -> dict:
    """hpo-default-T512: ``run_hpo(build_trimodal, ...)`` over
    DEFAULT_SPACE, 16 trials, seed 0, 66 synthetic subjects at T=512 with
    matrix connectivity (18, 18, 3), one proxy and one full epoch,
    ``top_fraction=0.25``. Every trial must finish, those at head dims
    between the kernel instances included; K1's launches by head dim are
    held to the count derived from each trial's flash layers (attention
    dropout is on in every trial: K1 in the one validation forward a
    trial-epoch, none in training)."""
    from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
    from multimodal_eeg_fmri_tpu_torch.data.arrays import (
        balanced_class_weights,
        pad_rows,
        subset,
    )
    from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
        synthetic_eeg_trimodal,
    )
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        kernel_launches_by_head_dim,
    )
    from multimodal_eeg_fmri_tpu_torch.train.hpo import (
        DEFAULT_SPACE,
        OPT_KEYS,
        build_trimodal,
        run_hpo,
        sample_trials,
    )

    data = synthetic_eeg_trimodal(n_subjects=HPO_TRAIN + HPO_VAL,
                                  time_steps=T_SERVE, conn_as_matrix=True)
    data.pop("subject")
    train = pad_rows(subset(data, np.arange(HPO_TRAIN)), HPO_TRAIN)
    val = pad_rows(subset(data, np.arange(HPO_TRAIN, HPO_TRAIN + HPO_VAL)),
                   HPO_VAL)
    make_model = functools.partial(build_trimodal, device=dev,
                                conn_shape=data["conn"].shape[1:])
    trials = sample_trials(DEFAULT_SPACE, HPO_TRIALS, seed=0)

    def arch(t):
        return {k: v for k, v in t.items() if k not in OPT_KEYS}

    layers = {}
    for t in trials:
        key = tuple(sorted(arch(t).items()))
        if key not in layers:
            layers[key] = flash_layers(make_model(**arch(t)), val)
    reset_all_launches()
    res, seconds = timed(lambda: run_hpo(
        make_model, TrainConfig(), train, val, space=DEFAULT_SPACE,
        n_trials=HPO_TRIALS, proxy_epochs=1, full_epochs=1,
        top_fraction=HPO_TOP, seed=0,
        class_weights=balanced_class_weights(train["label"])))
    by_dim = kernel_launches_by_head_dim()
    launches = total_launches()
    k = max(1, int(round(HPO_TRIALS * HPO_TOP)))
    finalists = [trials[i] for i in np.argsort(-res.rung_scores[0])[:k]]
    expected = {}
    for t in trials + finalists:
        d = t["hidden_dim"] // t["num_heads"]
        expected[d] = expected.get(d, 0) + layers[tuple(sorted(
            arch(t).items()))]
    expected = dict(sorted(expected.items()))
    dims = [t["hidden_dim"] // t["num_heads"] for t in trials]
    print(f"hpo-default-T{T_SERVE}: {HPO_TRIALS} trials + {k} finalists in "
          f"{seconds:.2f} s {card}; head dims of the trials {sorted(dims)}")
    print(f"rung 1 scores {np.array2string(res.rung_scores[0], precision=4)}"
          f"; rung 2 {np.array2string(res.rung_scores[1], precision=4)}; "
          f"best {res.best_params} ({res.best_score:.4f})")
    print(f"K1 launches by head dim {by_dim['flash_fwd']} (expected "
          f"{expected}), in total {launches['flash_fwd']}; K2 "
          f"{launches['flash_bwd_dkv']}, K3 {launches['flash_bwd_dq']}")
    if not all(np.all(np.isfinite(s)) for s in res.rung_scores):
        fail("an HPO trial did not finish with a finite score")
    if not set(PADDED_DIMS) <= set(dims):
        fail(f"the trials' head dims {sorted(set(dims))} miss one of "
             f"{PADDED_DIMS}")
    if (by_dim["flash_fwd"] != expected or launches["flash_bwd_dkv"]
            or launches["flash_bwd_dq"]):
        fail("hpo launched other than expected")
    return {"seconds": seconds, "launches": launches,
            "flash_fwd_by_head_dim": by_dim["flash_fwd"],
            "best_score": res.best_score}


def padded_predictor_gate(dev, card: str) -> dict:
    """One Predictor batch of TriModalFusionNetV4(hidden_dim=96,
    num_heads=4) at T=512 (head dim 24: K1 on the padded instance, 32)
    against the einsum route."""
    from multimodal_eeg_fmri_tpu_torch import Predictor, init_weights
    from multimodal_eeg_fmri_tpu_torch.models import TriModalFusionNetV4
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        kernel_launches_by_head_dim,
    )

    model = init_weights(TriModalFusionNetV4(hidden_dim=96, num_heads=4,
                                             device=dev),
                         torch.Generator().manual_seed(12))
    rows = {k: v for k, v in request(BATCH, T_SERVE, seed=61).items()
            if k in ("erp", "pw", "conn")}
    reset_all_launches()
    logits = Predictor(model, BATCH, return_probs=False)(**rows)
    by_dim = kernel_launches_by_head_dim()["flash_fwd"]
    plain = Predictor(einsum_route(copy.deepcopy(model)), BATCH,
                      return_probs=False)(**rows)
    d = float(np.abs(logits - plain).max())
    print(f"Predictor batch of TriModalFusionNetV4(hidden_dim=96, "
          f"num_heads=4) at T={T_SERVE}: K1 launches by head dim {by_dim}; "
          f"logits vs einsum route max|d|={d:.3e} (limit {LOGITS_ATOL:g})")
    if by_dim != {24: 4} or not d <= LOGITS_ATOL:
        fail("the D=24 Predictor batch launched otherwise or disagrees with "
             "the einsum route")
    return {"launches": by_dim, "max_abs_err": d}


def pipelines_phase(dev, card: str) -> dict:
    """The pipelines phase: pipelines-all-T512, hpo-default-T512 and the
    D=24 Predictor batch; a ``pipelines`` JSON line."""
    t0 = time.perf_counter()
    pred = padded_predictor_gate(dev, card)
    pipes = pipelines_all_phase(dev, card)
    hpo = hpo_phase(dev, card)
    seconds = time.perf_counter() - t0
    print(f"pipelines phase: {seconds:.1f} s {card}")
    return {"predictor_D24": pred, "all": pipes, "hpo": hpo,
            "phase_s": seconds}


# --- the sequence-parallel slice: ring attention over torch.distributed ----

RING_T, RING_SEQ, RING_COHORT, RING_VAL, RING_EPOCHS = 8192, 4, 32, 8, 3
RING_HEADS_MESH = (2, 2)          # lc-ring-heads: (seq, model)
RING_SEED = 0                     # the weights, on every rank and the card
RING_HISTORY_RTOL, RING_HISTORY_ATOL = 2e-4, 2e-5  # tests/test_long_context_training.py:74
RING_GRAD_RTOL = 3e-4             # per tensor of its largest (ROADMAP C8)
RING_CHUNK_ROWS = 2               # the einsum-chunk ring's rows: (T/4)² f32 tiles
RING_TIMED_STEPS = 5
# past head dim 128: K1, K2 and K3 on the split tensor-core kernels
# (csrc/flash_fwd_split.cu, csrc/flash_bwd_split.cu) up to 256, the head dim
# padded to an instance in SPLIT_DIMS; past it K1 on the CUDA cores
# (csrc/flash_wide.cu) and K2, K3 on the deep tensor-core kernels
# (csrc/flash_bwd_deep.cu), the head dim padded to a multiple of 64; the
# port's ops/attention.py:_launch decides which
WIDE_DIMS = (160, 256)            # timed on the split kernels
DEEP_DIMS = (320, 512)            # timed past 256
# checked against the plain versions
WIDE_CHECK_DIMS = (160, 192, 256, 257, 320, 384, 512)
WIDE_SHAPE = (8, 4, 512)          # (B, H, T) of their checks and times
WIDE_SYMBOL = re.compile(r"flash_wide_fwd_kernelI(f|13__nv_bfloat16)Lb([01])E")
DEEP_KERNELS = ("flash_bwd_dkv_deep", "flash_bwd_dq_deep")
DEEP_INSTANCES = {(k, s, o) for k in DEEP_KERNELS for s in ("f32", "bf16")
                  for o in ("f32", "bf16")}
DEEP_SYMBOL = re.compile(r"flash_(bwd_dkv|bwd_dq)_deep_kernel"
                         r"I(f|13__nv_bfloat16)Lb([01])E")
DEEP_SOURCE = "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd_deep.cu"
# the CUDA-core K2 and K3 that the deep kernels replaced, their last times
# per call at (8, 4, 512, 320) in f32 storage (PERF.md §6): printed beside
# the deep kernels' at that shape
CUDA_CORE_BWD_MS = {"flash_bwd_dkv": 6.4599, "flash_bwd_dq": 5.3623}
SPLIT_DIMS = (192, 256)
SPLIT_KERNELS = ("flash_fwd_split", "flash_bwd_dkv_split",
                 "flash_bwd_dq_split")
SPLIT_INSTANCES = {(k, d, s, o) for k in SPLIT_KERNELS for d in SPLIT_DIMS
                   for s in ("f32", "bf16") for o in ("f32", "bf16")}
SPLIT_SYMBOL = re.compile(r"flash_(fwd|bwd_dkv|bwd_dq)_split_kernel"
                          r"ILi(\d+)E(f|13__nv_bfloat16)Lb([01])E")
SPLIT_SOURCES = {
    "flash_fwd": "multimodal_eeg_fmri_tpu_torch/csrc/flash_fwd_split.cu",
    "flash_bwd_dkv": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd_split.cu",
    "flash_bwd_dq": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd_split.cu"}
WIDE_SOURCE = "multimodal_eeg_fmri_tpu_torch/csrc/flash_wide.cu"
# lc-d256-T2048 and lc-d512-T2048: LongContextClassifier at head dims 256
# and 512 (2 layers, no MoE), and the (B, H, T, D) of their K1-K3 calls
LC_WIDE = dict(hidden_dim=512, num_heads=2)
LC_WIDE_SHAPE = (BATCH, 2, LC_T, 256)
LC_DEEP = dict(hidden_dim=512, num_heads=1)
LC_DEEP_SHAPE = (BATCH, 1, LC_T, 512)


def split_instance(symbol: str):
    """(kernel, D, storage, operands) of a split kernel's mangled symbol,
    or None."""
    m = SPLIT_SYMBOL.search(symbol)
    if m is None:
        return None
    return (f"flash_{m[1]}_split", int(m[2]),
            "f32" if m[3] == "f" else "bf16", "bf16" if m[4] == "1" else "f32")


def wide_instances(d: int) -> dict:
    """The C entry point and launch head dim ("<entry> D=<kd>") each of
    K1, K2 and K3 takes at true head dim d, as the port's wrappers choose
    them (``ops/attention.py:_launch``) and count them
    (``kernel_launches_by_instance``)."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import _launch

    return {n: "{} D={}".format(*_launch(f"mmef_{n}", d))
            for n in MMA_KERNELS}


def wide_route(name: str, d: int) -> str:
    """The name of the kernel that runs K1, K2 or K3 (``name``) at head
    dim d: its C entry point's, without the ``mmef_`` prefix (past 128
    ``<name>_split`` up to 256, then ``flash_fwd_wide`` and
    ``<name>_deep``)."""
    return wide_instances(d)[name].split(" ")[0].removeprefix("mmef_")


def wide_instance(symbol: str):
    """(kernel, storage, operands) of the CUDA-core K1's mangled symbol,
    or None."""
    m = WIDE_SYMBOL.search(symbol)
    if m is None:
        return None
    return ("flash_fwd_wide", "f32" if m[1] == "f" else "bf16",
            "bf16" if m[2] == "1" else "f32")


def deep_instance(symbol: str):
    """(kernel, storage, operands) of a deep K2 or K3 kernel's mangled
    symbol (``csrc/flash_bwd_deep.cu``: one instance a mode serves every
    head dim), or None."""
    m = DEEP_SYMBOL.search(symbol)
    if m is None:
        return None
    return (f"flash_{m[1]}_deep", "f32" if m[2] == "f" else "bf16",
            "bf16" if m[3] == "1" else "f32")


def wide_phase(dev, card: str) -> dict:
    """K1, K2 and K3 past head dim 128 against their plain versions at
    (8, 4, 512, d), d in WIDE_CHECK_DIMS: f32 storage at the f32 gates, bf16
    storage and the bf16-operand mode at theirs, one launch of each counted
    at d and at the instance ``wide_instances`` names, and each kernel equal
    bit for bit on a second call; then their times at WIDE_DIMS (the split
    kernels) and DEEP_DIMS (the CUDA-core K1, the deep K2 and K3), events
    and device time, beside the plain versions', the bound and SDPA's, and
    in the other two modes; at 320 the deep K2 and K3 beside the CUDA-core
    kernels' last times (CUDA_CORE_BWD_MS). Returns the worst f32 errors by
    kernel and route and the times by d."""
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain,
        flash_bwd_dq_cuda,
        flash_bwd_dq_plain,
        flash_delta,
        flash_forward_cuda,
        flash_forward_plain,
        kernel_launches_by_head_dim,
        kernel_launches_by_instance,
    )

    gen = torch.Generator(device=dev).manual_seed(160)
    worst = {wide_route(n, d): 0.0 for n in MMA_KERNELS
             for d in (SPLIT_DIMS[-1], WIDE_CHECK_DIMS[-1])}
    out = {}
    for d in WIDE_CHECK_DIMS:
        for storage, cdt in (("f32", torch.float32), ("bf16", torch.float32),
                             ("f32", torch.bfloat16)):
            dtype = torch.float32 if storage == "f32" else torch.bfloat16
            q, k, v, g = (torch.randn(*WIDE_SHAPE, d, device=dev,
                                      generator=gen).to(dtype)
                          for _ in range(4))
            reset_all_launches()
            out_k, lse_k = flash_forward_cuda(q, k, v, cdt)
            out_p, lse_p = flash_forward_plain(q, k, v, cdt)
            delta = flash_delta(out_p, g)
            dk_k, dv_k = flash_bwd_dkv_cuda(q, k, v, g, lse_p, delta, cdt)
            dq_k = flash_bwd_dq_cuda(q, k, v, g, lse_p, delta, cdt)
            by_d = {n: c.get(d, 0) for n, c in
                    kernel_launches_by_head_dim().items()}
            by_instance = kernel_launches_by_instance()
            again = (*flash_forward_cuda(q, k, v, cdt),
                     *flash_bwd_dkv_cuda(q, k, v, g, lse_p, delta, cdt),
                     flash_bwd_dq_cuda(q, k, v, g, lse_p, delta, cdt))
            dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse_p, delta, cdt)
            dq_p = flash_bwd_dq_plain(q, k, v, g, lse_p, delta, cdt)
            torch.cuda.synchronize()
            repeats = all(torch.equal(a, b) for a, b in
                          zip((out_k, lse_k, dk_k, dv_k, dq_k), again))
            e_fwd = (out_k.float() - out_p.float()).abs().max().item()
            e_lse = (lse_k - lse_p).abs().max().item()
            e_dkv = max((dk_k.float() - dk_p.float()).abs().max().item(),
                        (dv_k.float() - dv_p.float()).abs().max().item())
            e_dq = (dq_k.float() - dq_p.float()).abs().max().item()
            if storage == "bf16":
                lim_fwd, lim_lse = BF16_ATOL, LSE_ATOL
                lim_dkv = grad_limit_bf16(max(dk_p.float().abs().max().item(),
                                              dv_p.float().abs().max().item()))
                lim_dq = grad_limit_bf16(dq_p.float().abs().max().item())
            elif cdt == torch.bfloat16:
                lim_fwd, lim_lse = BF16_ATOL, BF16_ATOL
                lim_dkv = lim_dq = GRAD_BF16_ATOL
            else:
                lim_fwd = lim_lse = KERNEL_ATOL
                lim_dkv = lim_dq = GRAD_ATOL
            mode = (f"{storage} storage, "
                    f"{'bf16' if cdt == torch.bfloat16 else 'f32'} operands")
            want = {n: {e: 1} for n, e in wide_instances(d).items()}
            print(f"(B,H,T,D)=({', '.join(map(str, WIDE_SHAPE))}, {d}) "
                  f"{mode}: max|dO|={e_fwd:.3e} (limit {lim_fwd:g}), "
                  f"max|dlse|={e_lse:.3e} (limit {lim_lse:g}), "
                  f"max|d(dK,dV)|={e_dkv:.3e} (limit {lim_dkv:.3e}), "
                  f"max|d(dQ)|={e_dq:.3e} (limit {lim_dq:.3e}); K1, K2 and "
                  f"K3 bit for bit on a second call: {repeats}; launches at "
                  f"D={d}: {by_d}, by instance {by_instance}")
            if by_d != dict.fromkeys(by_d, 1) or by_instance != want:
                fail(f"the D={d} kernels launched {by_instance}, expected "
                     f"{want}")
            if not (e_fwd <= lim_fwd and e_lse <= lim_lse
                    and e_dkv <= lim_dkv and e_dq <= lim_dq):
                fail(f"a D={d} kernel ({mode}) disagrees with its plain "
                     "version")
            if not repeats:
                fail(f"K1, K2 or K3 at D={d} ({mode}) differs run to run")
            if storage == "f32" and cdt == torch.float32:
                for name, e in (("flash_fwd", max(e_fwd, e_lse)),
                                ("flash_bwd_dkv", e_dkv),
                                ("flash_bwd_dq", e_dq)):
                    route = wide_route(name, d)
                    worst[route] = max(worst[route], e)
    for d in (*WIDE_DIMS, *DEEP_DIMS):
        q, k, v, g = (torch.randn(*WIDE_SHAPE, d, device=dev, generator=gen)
                      for _ in range(4))
        out[d] = kernel_call_times(q, k, v, g, "f32", card, iters=20, n=20)
        o, lse = flash_forward_cuda(q, k, v)
        delta = flash_delta(o, g)
        qb, kb, vb, gb = (x.bfloat16() for x in (q, k, v, g))
        # the other two modes, for their speed
        modes = {
            "flash_fwd": (
                lambda: flash_forward_cuda(q, k, v, torch.bfloat16),
                lambda: flash_forward_cuda(qb, kb, vb)),
            "flash_bwd_dkv": (
                lambda: flash_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                           torch.bfloat16),
                lambda: flash_bwd_dkv_cuda(qb, kb, vb, gb, lse, delta)),
            "flash_bwd_dq": (
                lambda: flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                          torch.bfloat16),
                lambda: flash_bwd_dq_cuda(qb, kb, vb, gb, lse, delta))}
        for name, (ops_fn, st_fn) in modes.items():
            ops_ms, st_ms = (cuda_ms(f, iters=20) for f in (ops_fn, st_fn))
            t = out[d][name]
            t.update(bf16_operands_ms=ops_ms, bf16_storage_ms=st_ms)
            print(f"{wide_route(name, d)} at (B,H,T,D)={(*WIDE_SHAPE, d)}: "
                  f"{share(t['bound_ms'], t['device_ms'])} of its bound by "
                  f"device time; bf16 operands {ops_ms:.4f} ms, bf16 storage "
                  f"{st_ms:.4f} ms {card}")
            if d == DEEP_DIMS[0] and name in CUDA_CORE_BWD_MS:
                core = CUDA_CORE_BWD_MS[name]
                print(f"{wide_route(name, d)} at (B,H,T,D)="
                      f"{(*WIDE_SHAPE, d)}: {t['ms']:.4f} ms per call, "
                      f"{t['ms'] / core:.3f}x the CUDA-core kernel's "
                      f"{core} ms (PERF.md) {card}")
    return {"max_abs_err": worst, "times": out}


def lc_wide_phase(dev, card: str, kw: dict = LC_WIDE,
                  shape: tuple = LC_WIDE_SHAPE) -> dict:
    """lc-d<D>-T2048: one train step of ``LongContextClassifier(**kw)``
    (head dim D = ``shape[3]``, 2 layers, no MoE, flax's initial weights
    from a seed) on raw EEG (8, 2048, 18) through ``TrainStep``, its
    launches counted from 0 just before the step and read just after: K1,
    K2 and K3 once a layer each at the instances ``wide_instances`` names
    (the split kernels at D=256; the CUDA-core K1 and the deep K2 and K3 at
    D=512). Then the step against the einsum route and the CPU through
    ``lc_step_gate`` (each gradient within STEP_GRAD_RTOL plus
    ZOO_FLOOR_FACTOR times its tensor's card-vs-CPU gap on the einsum route:
    ROADMAP C8), both routes' step times, and K1-K3 per call at the step's
    shape, each held there to its plain version on the same inputs: K1 at
    KERNEL_ATOL, K2 (dK, dV) and K3 (dQ) at GRAD_ATOL."""
    from multimodal_eeg_fmri_tpu_torch import TrainConfig, init_weights
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
    from multimodal_eeg_fmri_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain,
        flash_bwd_dq_cuda,
        flash_bwd_dq_plain,
        flash_delta,
        flash_forward_cuda,
        flash_forward_plain,
        kernel_launches_by_instance,
    )
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    d = shape[3]
    label = f"lc-d{d}-T{LC_T}"
    base = init_weights(LongContextClassifier(**kw, device=dev),
                        torch.Generator().manual_seed(6))
    layers = base.num_layers
    batch = lc_cohort(BATCH, LC_T, 53, dev)
    cfg = TrainConfig(batch_size=BATCH, learning_rate=1e-3,
                      weight_decay=1e-5, grad_clip=1.0, loss="weighted_ce")
    cw = torch.ones(2, device=dev)
    step = TrainStep(copy.deepcopy(base), cfg)
    reset_all_launches()
    step(batch, cw)
    torch.cuda.synchronize()
    by_instance = kernel_launches_by_instance()
    want = {n: {e: layers} for n, e in wide_instances(d).items()}
    print(f"{label}: one train step of LongContextClassifier("
          f"{', '.join(f'{k}={v}' for k, v in kw.items())}), B={BATCH}: "
          f"launches by instance {by_instance} (expected {want})")
    if by_instance != want:
        fail(f"{label} launched {by_instance}, expected {want}")
    gate = lc_step_gate(base, batch, cfg, cw, dev, f"{label}: ", None)
    if (gate["kernel"], gate["einsum"]) != (lc_expected(layers, 1, 0, 0),
                                            lc_expected(0, 0, 0, 0)):
        fail(f"{label}: the gated step launched {gate}")
    einsum_step = TrainStep(einsum_route(copy.deepcopy(base)), cfg)
    kernel_ms, einsum_ms = in_turns(
        lambda: step_ms(step, batch, cw, iters=5),
        lambda: step_ms(einsum_step, batch, cw, iters=5))
    print(f"{label} train step: kernel route {kernel_ms:.3f} ms, einsum "
          f"route {einsum_ms:.3f} ms {card}")
    del step, einsum_step
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v, g = (torch.randn(*shape, device=dev, generator=gen)
                  for _ in range(4))
    kernels = kernel_call_times(q, k, v, g, "f32", card, iters=10, n=10)
    o, lse = flash_forward_cuda(q, k, v)
    o_p, lse_p = flash_forward_plain(q, k, v)
    err = max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item())
    kernels["flash_fwd"]["max_abs_err"] = err
    print(f"{wide_route('flash_fwd', d)} at (B,H,T,D)={shape}: max|dO|, "
          f"max|dlse| against the plain version {err:.3e} (limit "
          f"{KERNEL_ATOL:g})")
    if not err <= KERNEL_ATOL:
        fail(f"K1 at {shape} disagrees with its plain version")
    delta = flash_delta(o, g)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta)
    dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse, delta)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta)
    dq_p = flash_bwd_dq_plain(q, k, v, g, lse, delta)
    for name, what, pairs in (
            ("flash_bwd_dkv", "max|d(dK)|, max|d(dV)|",
             ((dk, dk_p), (dv, dv_p))),
            ("flash_bwd_dq", "max|d(dQ)|", ((dq, dq_p),))):
        err = max((a - b).abs().max().item() for a, b in pairs)
        kernels[name]["max_abs_err"] = err
        print(f"{wide_route(name, d)} at (B,H,T,D)={shape}: {what} against "
              f"the plain version {err:.3e} (limit {GRAD_ATOL:g})")
        if not err <= GRAD_ATOL:
            fail(f"{wide_route(name, d)} at {shape} disagrees with its "
                 "plain version")
    return {"launches": {n: sum(c.values()) for n, c in by_instance.items()},
            "by_instance": by_instance,
            "times": {"step_ms": kernel_ms, "einsum_step_ms": einsum_ms},
            "kernels": kernels}


def ring_cohort(n: int, T: int, seed: int) -> dict:
    """n subjects' raw EEG (n, T, 18) in host memory, half of each class,
    class 1 with its channels' mean shifted by 0.3, from a seed (numpy, so
    that every rank and the single-device run make the same arrays)."""
    r = np.random.default_rng(seed)
    label = np.arange(n) % 2
    erp = (r.standard_normal((n, T, 18), dtype=np.float32)
           + np.float32(0.3) * label[:, None, None].astype(np.float32))
    return {"erp": erp, "label": label, "weight": np.ones(n, np.float32)}


def ring_setup():
    """(train cohort, validation rows, the step gate's batch, config)."""
    from multimodal_eeg_fmri_tpu_torch import TrainConfig

    cohort = ring_cohort(RING_COHORT, RING_T, 60)
    val = ring_cohort(RING_VAL, RING_T, 61)
    batch = {k: v[:BATCH] for k, v in cohort.items()}
    cfg = TrainConfig(batch_size=BATCH, num_epochs=RING_EPOCHS,
                      learning_rate=1e-3, weight_decay=1e-5, grad_clip=1.0,
                      loss="weighted_ce", selection="val")
    return cohort, val, batch, cfg


def ring_model(dev, mesh=None, heads=None, impl: str = "flash"):
    """``LongContextClassifier`` at its JAX defaults (hidden 64, 2 layers,
    4 heads, patch 1, no experts, dropout 0), the weights from RING_SEED:
    on the ring route over ``mesh``'s "seq" axis, or single-device on the
    flash route."""
    from multimodal_eeg_fmri_tpu_torch import init_weights
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier

    model = LongContextClassifier(
        attn_impl="flash" if mesh is None else "ring", mesh=mesh,
        seq_axis="seq", head_axis=heads, ring_chunk_impl=impl, device=dev)
    return init_weights(model, torch.Generator().manual_seed(RING_SEED))


def on_device(tree: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}


def step_grads(model, batch: dict, cfg, dev) -> tuple:
    """(loss, {name: gradient in host memory}, launches) of one
    ``TrainStep.backward`` (the mean over the model's mesh)."""
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    reset_all_launches()
    loss = TrainStep(model, cfg).backward(on_device(batch, dev),
                                          torch.ones(2, device=dev))
    torch.cuda.synchronize()
    return (loss.item(), {k: p.grad.double().cpu()
                          for k, p in model.named_parameters()},
            total_launches())


def ring_step_ms(model, batch: dict, cfg, dev) -> float:
    """ms of one ``TrainStep`` (forward, backward, the mean over the mesh,
    AdamW), by the host's clock around RING_TIMED_STEPS synchronised
    steps after one warm-up."""
    from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

    step = TrainStep(model, cfg)
    b, cw = on_device(batch, dev), torch.ones(2, device=dev)
    step(b, cw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RING_TIMED_STEPS):
        step(b, cw)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / RING_TIMED_STEPS


def ring_worker(rank: int, world: int, one_card_each: bool) -> dict:
    """One rank of the 4-rank world: the lc-ring-T8192 fit and step, the
    einsum-chunk ring against the flash-chunk ring, and lc-ring-heads'
    step on a (seq 2 × model 2) mesh of the same world. Returns the rank's
    results in host memory."""
    from multimodal_eeg_fmri_tpu_torch import make_fit_fn
    from multimodal_eeg_fmri_tpu_torch.parallel import (
        Mesh,
        reset_staged_bytes,
        shard_sequence,
        staged_bytes,
    )

    # the module (``ops.attention`` the package attribute is the function)
    attention = importlib.import_module(
        "multimodal_eeg_fmri_tpu_torch.ops.attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if one_card_each else 0)
    torch.cuda.set_device(dev)
    cohort, val, batch, cfg = ring_setup()
    mesh = Mesh(np.arange(world), ("seq",))
    out = {"device": str(dev)}

    model = ring_model(dev, mesh)
    fit = make_fit_fn(model, cfg, eval_names=("val",))
    train = on_device(shard_sequence(cohort, mesh, "seq"), dev)
    held = on_device(shard_sequence(val, mesh, "seq"), dev)
    torch.cuda.synchronize()
    reset_all_launches()
    reset_staged_bytes()
    t0 = time.perf_counter()
    result = fit(0, train, {"val": held}, torch.ones(2, device=dev))
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["fit_launches"] = total_launches()
    out["fit_staged"] = staged_bytes()
    out["history"] = {k: v.cpu() for k, v in result.history.items()}
    out["final"] = {k: v.cpu() for k, v in result.final_params.items()}

    # one step's gradient, with every g_lse that reaches K2/K3 recorded
    local = shard_sequence(batch, mesh, "seq")
    seen = {"calls": 0, "with_lse": 0, "max": 0.0}
    real = attention._flash_backward

    def spy(q, k, v, o, lse, g, g_lse, cdt):
        seen["calls"] += 1
        if g_lse is not None:
            seen["with_lse"] += 1
            seen["max"] = max(seen["max"], g_lse.abs().max().item())
        return real(q, k, v, o, lse, g, g_lse, cdt)

    attention._flash_backward = spy
    reset_staged_bytes()
    try:
        out["step"] = step_grads(ring_model(dev, mesh), local, cfg, dev)
    finally:
        attention._flash_backward = real
    out["step_staged"] = staged_bytes()
    out["g_lse"] = seen
    out["step_ms"] = ring_step_ms(ring_model(dev, mesh), local, cfg, dev)

    rows = {k: v[:RING_CHUNK_ROWS] for k, v in local.items()}
    out["chunks"] = {impl: step_grads(ring_model(dev, mesh, impl=impl), rows,
                                      cfg, dev)
                     for impl in ("flash", "einsum")}

    heads = Mesh(np.arange(world).reshape(RING_HEADS_MESH), ("seq", "model"))
    out["heads"] = step_grads(ring_model(dev, heads, heads="model"),
                              shard_sequence(batch, heads, "seq"), cfg, dev)
    return out


def ring_one_worker(rank: int, world: int) -> dict:
    """The world of one over NCCL: the ring of one's eval logits and one
    step of the ring model on the step gate's batch."""
    from multimodal_eeg_fmri_tpu_torch.parallel import Mesh
    from multimodal_eeg_fmri_tpu_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, _, batch, cfg = ring_setup()
    mesh = Mesh(np.arange(world), ("seq",))
    model = ring_model(dev, mesh)
    reset_all_launches()
    with torch.no_grad():
        logits = model.eval()(
            erp=torch.as_tensor(batch["erp"]).to(dev)).logits
    torch.cuda.synchronize()
    launches = total_launches()
    group = mesh.group("seq")
    return {"logits": logits.cpu(), "launches": launches,
            "backend": str(torch.distributed.get_backend(group)),
            "staged": collectives.staged_bytes(),
            "step": step_grads(ring_model(dev, mesh), batch, cfg, dev)}


def ring_grad_gate(what: str, loss: float, grads: dict, refs: dict,
                   noisy: set) -> dict:
    """``loss`` within the history gate's bounds of each reference route's
    (RING_HISTORY_ATOL + RING_HISTORY_RTOL of it: a mean over 8,192
    tokens, summed in another order on a ring), each gradient within
    RING_GRAD_RTOL of its tensor's largest, and the biases whose gradient
    is zero up to rounding (``noisy``) within STEP_GRAD_RTOL of the
    reference's largest gradient. Returns the worst per-tensor gap by
    reference."""
    worst_by = {}
    for name, (ref_loss, ref) in refs.items():
        loss_limit = RING_HISTORY_ATOL + RING_HISTORY_RTOL * abs(ref_loss)
        g_max = max(g.abs().max().item() for g in ref.values())
        rel = {k: rel_gap(grads[k], g) for k, g in ref.items()
               if k not in noisy}
        worst = max(rel, key=rel.get)
        d_noisy = max(((grads[k] - ref[k]).abs().max().item()
                       for k in noisy), default=0.0) / g_max
        d_loss = abs(loss - ref_loss)
        print(f"{what}vs {name}: loss {loss:.7f} vs {ref_loss:.7f} "
              f"(|d|={d_loss:.3e}, limit {loss_limit:.3e}); gradients "
              f"max|d|/max|g| per tensor up to {rel[worst]:.3e} at {worst} "
              f"(limit {RING_GRAD_RTOL:g}); the {len(noisy)} key biases "
              f"max|d| / the largest gradient {d_noisy:.3e} (limit "
              f"{STEP_GRAD_RTOL:g})")
        if not (d_loss <= loss_limit and rel[worst] <= RING_GRAD_RTOL
                and d_noisy <= STEP_GRAD_RTOL):
            fail(f"{what}the gradient disagrees with {name}")
        worst_by[name] = rel[worst]
    return worst_by


def f64_step(model, batch: dict, dev) -> tuple:
    """(loss, {name: gradient}) of one step of a float64 copy of ``model``
    on the einsum route, row by row (the model couples no rows, and the
    weighted loss of the batch is the sum of each row's loss times its
    share of the batch's weight), so that the (T, T) f64 scores of one row
    at a time fit on the card."""
    from multimodal_eeg_fmri_tpu_torch.ops.losses import (
        weighted_cross_entropy,
    )

    m = einsum_route(copy.deepcopy(model)).double().train()
    cw = torch.ones(2, dtype=torch.float64, device=dev)
    label = torch.as_tensor(batch["label"]).to(dev)
    weight = torch.as_tensor(batch["weight"]).to(dev, torch.float64)
    eff = weight * cw[label]
    total = 0.0
    for i in range(len(label)):
        erp = torch.as_tensor(batch["erp"][i:i + 1]).to(dev, torch.float64)
        loss = weighted_cross_entropy(m(erp=erp).logits, label[i:i + 1], cw,
                                      weight[i:i + 1]) * eff[i] / eff.sum()
        loss.backward()
        total += loss.item()
    return total, {k: p.grad.cpu() for k, p in m.named_parameters()}


def ring_phase(dev, card: str) -> dict:
    """lc-ring-T8192, lc-ring-heads and a world of one over NCCL, after
    the single-device references on ``dev``: the flash-route fit at
    T=8192 and one step on the kernel route and on a float64 einsum copy."""
    from multimodal_eeg_fmri_tpu_torch import make_fit_fn
    from multimodal_eeg_fmri_tpu_torch.parallel import spawn_local_world

    cohort, val, batch, cfg = ring_setup()
    steps = RING_EPOCHS * (RING_COHORT // BATCH)
    phase(f"lc-ring-T{RING_T}: the single-device references on {dev}: the "
          f"flash-route fit at T={RING_T}, one step on the kernel route and "
          "on a float64 einsum copy")
    single = ring_model(dev)
    layers = single.num_layers
    fit = make_fit_fn(single, cfg, eval_names=("val",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(0, on_device(cohort, dev), {"val": on_device(val, dev)},
              torch.ones(2, device=dev))
    torch.cuda.synchronize()
    single_fit_s = time.perf_counter() - t0
    single_hist = {k: v.cpu() for k, v in res.history.items()}
    single_step = step_grads(ring_model(dev), batch, cfg, dev)
    single_ms = ring_step_ms(ring_model(dev), batch, cfg, dev)
    f64 = f64_step(ring_model(dev), batch, dev)
    noisy = {k for k in single_step[1] if k.endswith("k_proj.bias")}
    print(f"single device: fit {single_fit_s:.2f} s ({steps} steps, "
          f"{RING_EPOCHS} evals), a step {single_ms:.2f} ms, train loss "
          f"{single_hist['train_loss'].numpy()} {card}")
    del single, fit, res
    torch.cuda.empty_cache()

    cards = torch.cuda.device_count()
    one_card_each = cards >= RING_SEQ
    backend = "nccl" if one_card_each else "gloo"
    per_card = 1 if one_card_each else RING_SEQ
    phase(f"lc-ring-T{RING_T}: LongContextClassifier(attn_impl='ring', "
          f"ring_chunk_impl='flash') over a seq axis of {RING_SEQ}, T_local "
          f"{RING_T // RING_SEQ}: {RING_SEQ} ranks on {backend}, {per_card} "
          f"rank(s) a card; then lc-ring-heads on a {RING_HEADS_MESH} "
          "(seq, model) mesh of the same world")
    t0 = time.perf_counter()
    ranks = spawn_local_world(ring_worker, RING_SEQ, one_card_each,
                              backend=backend)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"backend {backend}, world {RING_SEQ}, ranks a card {per_card}, "
          f"devices {[r['device'] for r in ranks]}; the world's run "
          f"{world_s:.1f} s (process start-up included) {card}")
    staged_step = [r["step_staged"] for r in ranks]
    print(f"bytes staged through host memory per train step (forward, "
          f"backward and the gradient mean), by rank: {staged_step}; over "
          f"the fit: {[r['fit_staged'] for r in ranks]}")

    # gate d: the launches, exactly, on every rank
    hops = layers * RING_SEQ
    want_fit = {"flash_fwd": hops * (steps + RING_EPOCHS),
                "flash_bwd_dkv": hops * steps, "flash_bwd_dq": hops * steps}
    want_step = dict.fromkeys(want_fit, hops)
    head_hops = layers * RING_HEADS_MESH[0]
    want_heads = dict.fromkeys(want_fit, head_hops)
    for r, res in enumerate(ranks):
        got = (res["fit_launches"], res["step"][2], res["heads"][2])
        print(f"rank {r}: launches fit {got[0]} (expected {want_fit}), step "
              f"{got[1]} (expected {want_step}), heads step {got[2]} "
              f"(expected {want_heads})")
        if got != (want_fit, want_step, want_heads):
            fail(f"rank {r} launched {got}")

    # gate e: the lse cotangent reached K2/K3
    seen = [r["g_lse"] for r in ranks]
    largest = ", ".join(f"{s['max']:.3e}" for s in seen)
    print(f"gate e: K2/K3 calls of the step with a g_lse, by rank "
          f"{[s['with_lse'] for s in seen]} of {[s['calls'] for s in seen]};"
          f" largest |g_lse| by rank {largest}")
    if not all(s["with_lse"] == s["calls"] == hops and s["max"] > 0
               for s in seen):
        fail("gate e: a K2/K3 call of the ring's step had no nonzero g_lse")

    # gate a: the loss history against the single-device fit
    for r, res in enumerate(ranks):
        for k, v in res["history"].items():
            if not torch.equal(v, r0["history"][k]):
                fail(f"rank {r}'s {k} history differs from rank 0's")
        for k, v in res["final"].items():
            if not torch.equal(v, r0["final"][k]):
                fail(f"rank {r}'s final {k} differs from rank 0's")
    a = r0["history"]["train_loss"].double().numpy()
    b = single_hist["train_loss"].double().numpy()
    gap = np.abs(a - b)
    limit = RING_HISTORY_ATOL + RING_HISTORY_RTOL * np.abs(b)
    print(f"gate a: ring train loss {a} vs single device {b}: |d| "
          f"{gap.max():.3e} (limit {RING_HISTORY_ATOL:g} + "
          f"{RING_HISTORY_RTOL:g}·|b|); val f1 ring "
          f"{r0['history']['val_f1'].numpy()} vs single "
          f"{single_hist['val_f1'].numpy()}; every rank's history and "
          "final params equal")
    if not np.all(gap <= limit):
        fail("gate a: the ring fit's loss history disagrees with the "
             "single-device fit's")

    # gate b: one step's gradient per tensor
    loss, grads, _ = r0["step"]
    for r, res in enumerate(ranks):
        if any(not torch.equal(res["step"][1][k], g) for k, g in
               grads.items()):
            fail(f"rank {r}'s averaged gradient differs from rank 0's")
    refs = {"the single-device kernel route": single_step[:2],
            "the float64 einsum copy": f64}
    worst_b = ring_grad_gate(f"lc-ring-T{RING_T} gate b: the ring's step ",
                             loss, grads, refs, noisy)
    ring_grad_gate(f"lc-ring-T{RING_T} gate b: (the single-device kernel "
                   "route's own step) ", single_step[0], single_step[1],
                   {"the float64 einsum copy": f64}, noisy)

    # gate c: the einsum-chunk ring against the flash-chunk ring
    flash_c, einsum_c = r0["chunks"]["flash"], r0["chunks"]["einsum"]
    ring_grad_gate(f"lc-ring-T{RING_T} gate c ({RING_CHUNK_ROWS} rows): "
                   "the flash-chunk ring ", flash_c[0], flash_c[1],
                   {"the einsum-chunk ring": einsum_c[:2]}, noisy)
    if einsum_c[2] != dict.fromkeys(einsum_c[2], 0):
        fail(f"the einsum-chunk ring launched {einsum_c[2]}")

    # lc-ring-heads: one step against the single-device step
    worst_h = ring_grad_gate(
        f"lc-ring-heads {RING_HEADS_MESH} (seq, model): the ring's step ",
        r0["heads"][0], r0["heads"][1], refs, noisy)

    phase("a world of one over NCCL: the ring of one against the "
          "single-device flash route")
    one = spawn_local_world(ring_one_worker, 1, backend="nccl")[0]
    single = ring_model(dev)
    with torch.no_grad():
        want = single.eval()(erp=torch.as_tensor(batch["erp"]).to(dev))
    d_logits = (one["logits"] - want.logits.cpu()).abs().max().item()
    print(f"backend {one['backend']}, bytes staged {one['staged']}; "
          f"launches of one eval forward {one['launches']}; logits max|d| "
          f"{d_logits:.3e} (limit {KERNEL_ATOL:g})")
    if not (one["backend"] == "nccl" and d_logits <= KERNEL_ATOL
            and one["launches"] == {"flash_fwd": layers, "flash_bwd_dkv": 0,
                                    "flash_bwd_dq": 0}):
        fail("the ring of one disagrees with the single-device flash route")
    ring_grad_gate("ring of one over NCCL: its step ", one["step"][0],
                   one["step"][1],
                   {"the single-device kernel route": single_step[:2]},
                   noisy)

    times = {"backend": backend, "world": RING_SEQ, "ranks_per_card":
             per_card, "staged_bytes_per_step": staged_step[0],
             "fit_s": r0["fit_s"], "single_fit_s": single_fit_s,
             "step_ms": [r["step_ms"] for r in ranks],
             "single_step_ms": single_ms,
             "g_lse_max": max(s["max"] for s in seen),
             "grad_gap_f64": worst_b["the float64 einsum copy"],
             "heads_grad_gap_f64": worst_h["the float64 einsum copy"],
             "world_s": world_s}
    print(f"lc-ring-T{RING_T}: fit {r0['fit_s']:.2f} s on rank 0 against "
          f"{single_fit_s:.2f} s on one device; a train step "
          f"{', '.join(f'{t:.2f}' for t in times['step_ms'])} ms by rank "
          f"against {single_ms:.2f} ms ({backend}, {per_card} rank(s) a "
          f"card) {card}")
    return {"launches": {"fit": r0["fit_launches"], "step": r0["step"][2],
                         "heads": r0["heads"][2], "one": one["launches"]},
            "times": times}


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
            + [(s, torch.float32, KERNEL_ATOL)
               for s in RAGGED_SHAPES + PADDED_SHAPES]
            + [((8, 4, 512, 512, 32), torch.bfloat16, BF16_ATOL)]
            + [(s, torch.bfloat16, BF16_ATOL) for s in PADDED_SHAPES]):
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
            + [(s, torch.float32, GRAD_ATOL)
               for s in RAGGED_SHAPES + PADDED_SHAPES]
            + [((8, 4, 512, 512, 32), torch.bfloat16, GRAD_BF16_ATOL)]
            + [(s, torch.bfloat16, GRAD_BF16_ATOL) for s in PADDED_SHAPES]):
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

    phase(f"K1, K2 and K3 past gridDim.y's limit: (B,H,T,D)={GRID_CASE}, "
          f"B·H = {GRID_CASE[0] * GRID_CASE[1]:,}")
    B, H, T, d = GRID_CASE
    q, k, v, g = (torch.randn(B, H, T, d, device=dev, generator=gen)
                  for _ in range(4))
    out_k, lse_k = flash_forward_cuda(q, k, v)
    out_p, lse_p = flash_forward_plain(q, k, v)
    delta = flash_delta(out_p, g)
    dk_k, dv_k = flash_bwd_dkv_cuda(q, k, v, g, lse_p, delta)
    dq_k = flash_bwd_dq_cuda(q, k, v, g, lse_p, delta)
    dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, g, lse_p, delta)
    dq_p = flash_bwd_dq_plain(q, k, v, g, lse_p, delta)
    torch.cuda.synchronize()
    e_fwd = max((out_k - out_p).abs().max().item(),
                (lse_k - lse_p).abs().max().item())
    e_bwd = max((a - b).abs().max().item()
                for a, b in ((dk_k, dk_p), (dv_k, dv_p), (dq_k, dq_p)))
    print(f"max|d(O, lse)|={e_fwd:.3e} (limit {KERNEL_ATOL:g}), "
          f"max|d(dQ, dK, dV)|={e_bwd:.3e} (limit {GRAD_ATOL:g})")
    if not (e_fwd <= KERNEL_ATOL and e_bwd <= GRAD_ATOL):
        fail(f"the kernels disagree with their plain versions at {GRID_CASE}")
    del q, k, v, g, out_k, out_p, delta, dk_k, dv_k, dq_k, dk_p, dv_p, dq_p
    torch.cuda.empty_cache()

    phase(f"fault C5: K2 and K3 in the bf16-operand mode at "
          f"{C5_CASE}, over {C5_SEEDS} seeds of g_lse")
    c5_sweep(dev)

    phase("kernel vs plain version in bf16 storage, f32 operands: K1, K2 "
          "and K3 at the main path's shapes and at the padded head dims "
          f"{PADDED_DIMS}")
    worst_bf16 = dict.fromkeys(worst, 0.0)
    for B, H, T, d in SLICE_SHAPES + [(8, 4, 512, d) for d in PADDED_DIMS]:
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

    phase(f"kernel vs plain version past head dim 128 at D="
          f"{WIDE_CHECK_DIMS}: K1, K2 and K3 on the split tensor-core kernels"
          f" (csrc/flash_fwd_split.cu, csrc/flash_bwd_split.cu) up to 256; "
          f"past it K1 on the CUDA cores (csrc/flash_wide.cu), K2 and K3 on "
          f"the deep tensor-core kernels (csrc/flash_bwd_deep.cu); f32 and "
          f"bf16 storage and bf16 operands {card}")
    wide = wide_phase(dev, card)

    phase(f"lc-d256-T{LC_T}: a train step of LongContextClassifier("
          f"hidden_dim=512, num_heads=2) on the split kernels {card}")
    lc_wide = lc_wide_phase(dev, card)
    print(json.dumps({"lc_d256": {**lc_wide["times"], "device": smi}}))

    phase(f"lc-d512-T{LC_T}: a train step of LongContextClassifier("
          f"hidden_dim=512, num_heads=1), K1 on the CUDA cores and K2, K3 on "
          f"the deep kernels {card}")
    lc_deep = lc_wide_phase(dev, card, LC_DEEP, LC_DEEP_SHAPE)
    print(json.dumps({"lc_d512": {**lc_deep["times"], "device": smi}}))

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
    step_gate("", losses, grads, cancelled_biases(base))

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
        # two layers of each shape per train step
        for name, t in kernel_call_times(q, k, v, g, storage, card).items():
            for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms", "library_device_ms"):
                was, now = per_step[name, storage][key], t[key]
                per_step[name, storage][key] = (
                    None if was is None or now is None else was + 2 * now)
            per_step[name, storage]["ops"] += 2 * (t["bound_by"]
                                                   == "operations")

    replaces = {"flash_fwd": "multimodal_eeg_fmri_tpu/ops/attention.py:63",
                "flash_bwd_dkv": "multimodal_eeg_fmri_tpu/ops/attention.py:121",
                "flash_bwd_dq": "multimodal_eeg_fmri_tpu/ops/attention.py:173"}
    source = {"flash_fwd": "multimodal_eeg_fmri_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd_dkv": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dq": "multimodal_eeg_fmri_tpu_torch/csrc/flash_bwd.cu"}
    for storage in ("f32", "bf16"):
        print(f"per train step, {storage} storage (2 layers at T=256, 2 at "
              f"T=512): " + "; ".join(
                  f"{k} {v['ms']:.4f} ms, device {_ms(v['device_ms'])} "
                  f"(bound {v['bound_ms']:.4f})"
                  for (k, st), v in per_step.items() if st == storage))

    phase(f"K1-K3 at a padded head dim: {PAD_TIMING_SHAPE} (the kernels' "
          f"D=32 instance) beside D=32 itself {card}")
    padded_times = {}
    for d in (PAD_TIMING_SHAPE[3], 32):
        q, k, v, g = (torch.randn(*PAD_TIMING_SHAPE[:3], d, device=dev,
                                  generator=gen) for _ in range(4))
        padded_times[d] = kernel_call_times(q, k, v, g, "f32", card)
    for name, t in padded_times[PAD_TIMING_SHAPE[3]].items():
        d32 = padded_times[32][name]["device_ms"]
        print(f"{name}: D={PAD_TIMING_SHAPE[3]} padded to 32 takes "
              f"{share(t['device_ms'], d32, '.3f')}x the device time of "
              f"D=32; {share(t['bound_ms'], t['device_ms'])} of the bound of "
              f"D={PAD_TIMING_SHAPE[3]}'s own work {card}")

    def timings(t: dict) -> dict:
        return {"ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops"] else "bytes",
                "library_ms": t["library_ms"],
                "library_device_ms": t["library_device_ms"]}

    def wide_timings(d: int, name: str) -> dict:
        t = wide["times"][d][name]
        return {"shape": [*WIDE_SHAPE, d],
                **timings({**t, "ops": t["bound_by"] == "operations"}),
                **{k: t[k] for k in ("bf16_operands_ms", "bf16_storage_ms")}}

    phase(f"cv: train/cv.py on the card {card}")
    cv = cv_phase(dev, card)

    phase(f"zoo: the model zoo on the card {card}")
    zoo = zoo_phase(dev, card)

    phase(f"lc: models/long_context.py and ops/moe.py on the card {card}")
    lc = lc_phase(dev, card)

    phase(f"bridge: xai/ and train/bridge_flow.py on the card {card}")
    bridge = bridge_phase(dev, card)

    phase(f"serving: serving.py, core/quantize.py, report/uncertainty.py and "
          f"report/drift.py on the card {card}")
    serving = serving_phase(dev, card)
    print(json.dumps({"serving": {**serving["times"],
                                  "flash_fwd_folded": serving["folded"],
                                  "device": smi}}))

    phase(f"pipelines: pipelines.py, __main__.py, train/hpo.py and the file "
          f"loaders on the card {card}")
    pipes = pipelines_phase(dev, card)
    print(json.dumps({"pipelines": {
        "seconds": pipes["all"]["seconds"],
        "ingest_s": pipes["all"]["ingest_s"],
        "ingest_path": pipes["all"]["ingest_path"],
        "cohort_write_s": pipes["all"]["cohort_write_s"],
        "hpo_s": pipes["hpo"]["seconds"],
        "hpo_flash_fwd_by_head_dim": pipes["hpo"]["flash_fwd_by_head_dim"],
        "phase_s": pipes["phase_s"], "device": smi}}))

    phase(f"ring: parallel/, ops/ring_attention.py and LongContextClassifier"
          f"(attn_impl='ring') on torch.distributed {card}")
    reset_all_launches()
    ring = ring_phase(dev, card)
    print(json.dumps({"ring": {**ring["times"], "device": smi}}))

    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source[name],
        "replaces": replaces[name],
        "launches": train_launches[name],
        # each path's launches: the training path's, run_cv's and the
        # bridge phase's
        "launches_by_path": {"train-e2e-T512": train_launches[name],
                             "cv-eeg-kfold-T512": cv["launches"][name],
                             **{f"zoo-suite-T512 {model}": v["launches"][name]
                                for model, v in zoo["suite"]["models"].items()},
                             **{f"zoo-step-T512 {model}, per step":
                                zoo["steps"][model][name]
                                for model in ZOO_STEP_MODELS},
                             "zoo-serve-gnn-T512, per batch": (
                                 zoo["steps"]["serve_gnn"]
                                 if name == "flash_fwd" else 0),
                             **{f"{cell} {path}": lc["launches"][path][name]
                                for cell, path in (
                                    (f"lc-moe-T{LC_T}", "fit"),
                                    (f"lc-moe-T{LC_T}", "remat_fit"),
                                    (f"lc-moe-T{LC_T}", "serve"),
                                    (f"lc-moe-T{LC_T}", "step"),
                                    (f"v4-moe-T{T_SERVE}", "v4_step"))},
                             **{path: n[name] for path, n in bridge.items()},
                             "serve-ensemble-T512, per batch": (
                                 serving["launches_per_batch"]
                                 if name == "flash_fwd" else 0),
                             **{f"pipelines-all-T{PIPE_T} {pipe}": n[name]
                                for pipe, n in
                                pipes["all"]["launches"].items()},
                             f"hpo-default-T{T_SERVE}":
                                 pipes["hpo"]["launches"][name],
                             # each rank's, K1-K3 at (8, 4, 2048, 16) a hop
                             f"lc-ring-T{RING_T} fit, per rank":
                                 ring["launches"]["fit"][name],
                             f"lc-ring-T{RING_T} step, per rank":
                                 ring["launches"]["step"][name],
                             "lc-ring-heads step, per rank":
                                 ring["launches"]["heads"][name],
                             "ring-nccl-world-1 eval forward":
                                 ring["launches"]["one"][name]},
        "max_abs_err": worst[name],
        **timings(per_step[name, "f32"]),
        # the mixed-precision fit's launches by storage, and the
        # bf16-storage instance's error and times
        "launches_bf16_fit": mp_launches[name],
        "bf16_storage": {"max_abs_err": worst_bf16[name],
                         **timings(per_step[name, "bf16"])},
        # K1 on the ensemble's folded batch (40, 4, 512, 32)
        **({"serve_ensemble_T512": serving["folded"]}
           if name == "flash_fwd" else {}),
        # each call at lc-moe-T2048's (8, 4, 2048, 16)
        f"lc_moe_T{LC_T}": lc["kernels"][name],
        # the largest lse cotangent that reached K2/K3 in the ring's step
        **({"ring_g_lse_max": ring["times"]["g_lse_max"]}
           if name != "flash_fwd" else {}),
        # each call at (8, 4, 512, 24), padded to the D=32 instance (the
        # bound from D=24's own work), and at D=32
        "padded_D24": {"shape": list(PAD_TIMING_SHAPE),
                       **timings({**padded_times[24][name], "ops": (
                           padded_times[24][name]["bound_by"]
                           == "operations")}),
                       "d32_device_ms": padded_times[32][name]["device_ms"]},
    } for name in names] + [{
        # past head dim 128: K1, K2 and K3 on the split kernels up to 256;
        # lc-d256-T2048's step is their main path, its per-call times at
        # the step's (8, 2, 2048, 256), K1 beside the CUDA-core K1
        "name": f"{name}_split",
        "route": "cuda",
        "source": SPLIT_SOURCES[name],
        "replaces": replaces[name],
        "launches": lc_wide["launches"][name],
        "launches_by_path": {f"lc-d256-T{LC_T} step":
                             lc_wide["launches"][name]},
        "max_abs_err": max(wide["max_abs_err"][f"{name}_split"],
                           lc_wide["kernels"][name]["max_abs_err"]),
        "shape": list(LC_WIDE_SHAPE),
        **timings({**lc_wide["kernels"][name], "ops": (
            lc_wide["kernels"][name]["bound_by"] == "operations")}),
        # each call at (8, 4, 512, d)
        **{f"D{d}": wide_timings(d, name) for d in WIDE_DIMS},
    } for name in names] + [{
        # past head dim 256: K1 on the CUDA cores, K2 and K3 on the deep
        # tensor-core kernels; lc-d512-T2048's step is their main path, its
        # per-call times at the step's (8, 1, 2048, 512)
        "name": wide_route(name, LC_DEEP_SHAPE[3]),
        "route": "cuda",
        "source": WIDE_SOURCE if name == "flash_fwd" else DEEP_SOURCE,
        "replaces": replaces[name],
        "launches": lc_deep["launches"][name],
        "launches_by_path": {f"lc-d512-T{LC_T} step":
                             lc_deep["launches"][name]},
        "max_abs_err": max(wide["max_abs_err"][wide_route(name, 512)],
                           lc_deep["kernels"][name]["max_abs_err"]),
        "shape": list(LC_DEEP_SHAPE),
        **timings({**lc_deep["kernels"][name], "ops": (
            lc_deep["kernels"][name]["bound_by"] == "operations")}),
        # each call at (8, 4, 512, d)
        **{f"D{d}": wide_timings(d, name) for d in DEEP_DIMS},
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
