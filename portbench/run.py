#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The run sets up from the seed (the kernel library is built into, or
loaded from, ``portbench/.cache/``), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line as the last line of its standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). With no card, too few cards, or a
JAX module loaded, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _finite(x):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.harness import env

    env.fix_caches()
    import torch

    from portbench.harness import cell, registry

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    from multimodal_eeg_fmri_tpu_torch.core.cache import (
        enable_compilation_cache,
    )
    from multimodal_eeg_fmri_tpu_torch.ops import _kernels

    enable_compilation_cache(str(env.CACHE_DIRS[
        "MULTIMODAL_EEG_FMRI_TPU_TORCH_CACHE_DIR"]))
    _kernels.library()            # built on a checkout's first run, else loaded
    ctx = cell.context(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda:0", T0)
    ctx.mark("imports, CUDA and the kernel library")
    result = cell.run(ctx, bench)
    found = env.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in this process: {found}: no result",
              file=sys.stderr)
        return 3
    for line in cell.checks_text(ctx.checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
