"""The control on the card: the plain reference in TF32 put in the
program's place fails at least one of each cell's limits, at a size a test
run holds, on three seeds. (``portbench/control.py`` reads it at the
cells' own sizes.)"""

import time

import pytest

from portbench.tests.small import SMALL
from portbench.harness import cell, registry


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_a_limit(cuda_device, name):
    small = dict(SMALL[name])
    if name != "mm-serve-ensemble-T512":
        small.update(T=512 if name.startswith("mm") else 2048, batch=8)
    for seed in (2**33 + 11, 2**33 + 12, 2**33 + 13):
        ctx = cell.context(name, seed, 0.0, False, cuda_device,
                           time.perf_counter(), params=small)
        cell.precision(ctx)
        checks = registry.driver(ctx.traffic["driver"]).control(ctx)
        assert any(not c.ok for c in checks), [(c.name, c.value, c.limit)
                                               for c in checks]
