"""Small sizes at which a CPU run of each cell takes seconds; the widths
stay the configurations' own."""

from __future__ import annotations

import time

from portbench.harness import cell, registry

SMALL = {
    "lc-moe-train-T2048": dict(T=64, batch=4, cohort=16, profile_steps=2),
    "mm-train-T512-b256": dict(T=64, batch=4, cohort=16, profile_steps=2),
    "mm-serve-ensemble-T512": dict(T=64, clients=4, pool=32, batch_size=4,
                                   max_batch=4, warmup_s=0.3,
                                   check_requests=16, profile_calls=2),
}


def run_small(name: str, seed: int = 2**33 + 5, trace: bool = False,
              device="cpu", seconds: float = 0.5, **params) -> dict:
    """One run of a cell at ``SMALL`` sizes (and ``params``)."""
    ctx = cell.context(name, seed, seconds, trace, device, time.perf_counter(),
                       params={**SMALL[name], **params})
    return cell.run(ctx, registry.benchmark())
