"""The operations and bounds the benchmark counts from shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import registry
from portbench.work import common


@pytest.mark.parametrize("kernel, ms", [("flash_fwd", 0.0521),
                                        ("flash_bwd_dkv", 0.1041),
                                        ("flash_bwd_dq", 0.0781)])
def test_kernel_bounds_as_perf_md_gives_them(kernel, ms):
    got, by = common.kernel_bound_ms(kernel, 8, 4, 2048, 2048, 16)
    assert round(got, 4) == ms and by == "operations"


def test_lc_moe_step_flops():
    cfg = registry.config("lc-moe")
    step = 3 * 8 * registry.work("lc-moe").forward_flops(cfg, 2048)
    assert step == pytest.approx(67.7e9, rel=0.01)


def _moe_layer(T=32, D=64, E=4):
    from multimodal_eeg_fmri_tpu_torch.ops.moe import MoEFFN

    torch.manual_seed(0)
    layer = MoEFFN(D, E, top_k=2, capacity_factor=4.0, device="cpu")
    return layer, torch.randn(1, T, D)


def test_moe_count_is_the_routed_rows_whatever_computes_them():
    """The work counts the router and top-k rows a token through the
    experts. The gather formulation (the reference) computes exactly that
    where no token is dropped; the program's dense dispatch computes more,
    and the count does not follow it."""
    ref = registry.reference("lc-moe")
    layer, x = _moe_layer()
    D, E, ff = 64, 4, 256
    p = {f"m.{n}": t.detach() for n, t in layer.named_parameters()}
    S = x.shape[1]
    counted = (common.dense(S, D, E)
               + 2 * (common.dense(S, D, ff) + common.dense(S, ff, D)))
    with FlopCounterMode(display=False) as gather:
        ref.moe(p, "m", x, E, 2, 4.0, 0.01)
    with FlopCounterMode(display=False) as dense:
        layer(x)
    assert gather.get_total_flops() == counted
    assert dense.get_total_flops() > counted


def test_mm_e2e_flops_match_the_reference_forward():
    cfg = registry.config("mm-e2e")
    T = 64
    model = registry.builder("mm-e2e").build(cfg, "cpu",
                                             torch.Generator().manual_seed(0))
    data = registry.builder("mm-e2e").cohort(
        cfg, 2, T, torch.Generator().manual_seed(1), "cpu")
    p = {**{n: q.detach() for n, q in model.named_parameters()},
         **dict(model.named_buffers())}
    inputs = {k: v for k, v in data.items() if k not in ("label", "weight")}
    forward = registry.reference("mm-e2e").make_forward(cfg["model"], False)
    with FlopCounterMode(display=False) as fc:
        forward(p, inputs)
    per_sample = registry.work("mm-e2e").forward_flops(cfg, T)
    assert fc.get_total_flops() == pytest.approx(2 * per_sample, rel=1e-9)


def test_attention_span_work():
    f, b = common.mha_work(8, 2048, 2048, 64, 4, True, False)
    assert f == common.mha_forward(8, 2048, 2048, 64, 4)
    f2, b2 = common.mha_work(8, 2048, 2048, 64, 4, True, True)
    assert f2 == 3 * f and b2 > b
    # the core alone bounds K1 at (8,4,2048,16) as PERF.md has it
    core = common.attention_core(8, 4, 2048, 2048, 16)
    assert common.bound_s(core, 0) * 1e3 == pytest.approx(0.0521, abs=5e-5)
