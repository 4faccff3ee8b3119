"""``chip_smoke.py``'s readers of compiler output, its bound and its
max-pool pinning, on the CPU.

The script itself needs a GPU. These helpers parse text and do arithmetic,
so they are held here to canned output in the formats of ``nvcc -Xptxas -v``
and ``cuobjdump -sass``; the max-pool recorder is held to the encoders'
pool on small tensors.
"""

import pytest

import chip_smoke

FWD = ("_ZN12_GLOBAL__N_116flash_fwd_kernelILi32EfLb0EEEvPKT0_S3_S3_PS1_"
       "Pfiiillllllllllfi")
DKV = ("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi128E13__nv_bfloat16Lb1EEEv"
       "PKT0_S3_S3_S3_PKfS5_PS1_S6_iiillllllllllllfi")
DQ = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi16EfLb1EEEvPKT0_"

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '{DKV}' for 'sm_90a'
ptxas info    : Function properties for {DKV}
    24 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 496 bytes cmem[0]
"""

SASS = f"""
\tcode for sm_90a
\t\tFunction : {FWD}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*1230*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*1240*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;
\t\tFunction : {DQ}
        /*0000*/                   FFMA R1, R2, R3, R4 ;
"""


@pytest.mark.parametrize("symbol,instance", [
    (FWD, ("flash_fwd", 32, "f32", "f32")),
    (DKV, ("flash_bwd_dkv", 128, "bf16", "bf16")),
    (DQ, ("flash_bwd_dq", 16, "f32", "bf16")),
    ("_Z10other_kernelPf", None),
])
def test_kernel_instance_reads_mangled_symbols(symbol, instance):
    assert chip_smoke.kernel_instance(symbol) == instance


def test_parse_ptxas_reads_registers_and_spills():
    """(registers, spill stores, spill loads, stack frame) per instance."""
    assert chip_smoke.parse_ptxas(PTXAS) == {
        ("flash_fwd", 32, "f32", "f32"): (128, 0, 0, 0),
        ("flash_bwd_dkv", 128, "bf16", "bf16"): (255, 12, 16, 24),
    }


S1 = {kernel: f"_ZN12_GLOBAL__N_120sosfilt_{kernel}_kernelILi4EEEv{args}"
      for kernel, args in (("local", "PKfPfNS_6CoeffsEiii"),
                           ("carry", "PKfPfPKdiii"),
                           ("rerun", "PKfPfS1_S1_S2_NS_6CoeffsEiiii"))}


def test_parse_ptxas_reads_s1_instances_by_sections():
    """S1's three kernels, each by its section count."""
    text = PTXAS + "".join(
        f"""ptxas info    : Compiling entry function '{sym}' for 'sm_90a'
ptxas info    : Function properties for {sym}
    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 0 barriers, 3488 bytes cmem[0]
""" for sym, regs, frame in ((S1["local"], 72, 0), (S1["carry"], 40, 8),
                             (S1["rerun"], 80, 0)))
    assert chip_smoke.s1_instance(S1["carry"]) == ("sosfilt_carry", 4)
    assert chip_smoke.s1_instance(FWD) is None
    assert chip_smoke.parse_ptxas(text, chip_smoke.s1_instance) == {
        ("sosfilt_local", 4): (72, 0, 0, 0),
        ("sosfilt_carry", 4): (40, 0, 0, 8),
        ("sosfilt_rerun", 4): (80, 0, 0, 0)}
    assert ("sosfilt_local", 4) not in chip_smoke.parse_ptxas(text)


def _s1_build():
    return {(k, n): (64, 0, 0, 0) for k in chip_smoke.S1_KERNELS
            for n in range(1, 9)}


def test_s1_gate_passes_a_full_build():
    assert chip_smoke.s1_faults(_s1_build()) == []


@pytest.mark.parametrize("inst,fault", [
    (("sosfilt_carry", 8), (64, 0, 0, 16)),     # a stack frame
    (("sosfilt_rerun", 5), (255, 8, 8, 0)),     # spills
    (("sosfilt_local", 1), None),               # missing
])
def test_s1_gate_names_the_faulty_instance(inst, fault):
    resources = _s1_build()
    if fault is None:
        del resources[inst]
    else:
        resources[inst] = fault
    faults = chip_smoke.s1_faults(resources)
    assert len(faults) == 1 and str(inst) in faults[0]


def test_s1_chain_floor_of_both_schedules():
    """Sequential: 4·T + 2·S f32 operations; chunked: 4·2·L + 2·S plus
    C − 1 carry steps of 2·S + 1 f64 operations."""
    clock = 2e9
    assert chip_smoke.s1_chain_ms(2554, 2554, 4, clock) == pytest.approx(
        1e3 * (4 * 2554 + 8) * 4 / clock)
    assert chip_smoke.s1_chain_ms(2554, 48, 4, clock) == pytest.approx(
        1e3 * ((4 * 96 + 8) * 4 + 53 * 9 * 8) / clock)


def test_count_hmma_counts_per_function():
    assert chip_smoke.count_hmma(SASS) == {
        ("flash_fwd", 32, "f32", "f32"): 2,
        ("flash_bwd_dq", 16, "f32", "bf16"): 0,
    }


@pytest.mark.parametrize("kernel,flops_per_term", [
    ("flash_fwd", 4), ("flash_bwd_dkv", 8), ("flash_bwd_dq", 6)])
def test_bound_is_the_3xtf32_rate_at_the_main_path_shape(kernel,
                                                          flops_per_term):
    ms, by = chip_smoke.bound_ms(kernel, 8, 4, 512, 512, 32)
    assert by == "operations"
    assert ms == pytest.approx(
        1e3 * flops_per_term * 32 * 512 * 512 * 32 / (495e12 / 3))


@pytest.mark.parametrize("kernel,stored,mixed", [
    ("flash_fwd", 1, 1), ("flash_bwd_dkv", 2, 2), ("flash_bwd_dq", 2, 1)])
def test_bf16_storage_bound_splits_the_products(kernel, stored, mixed):
    """With bf16 storage the products of two stored tensors run at the bf16
    rate, and those of an f32 operand (P, dS) with a stored one, exact in
    bf16, at a third of it: the f32 operand in three bf16 pieces, faster
    than two TF32 pieces (495/2 TFLOP/s)."""
    ms, by = chip_smoke.bound_ms(kernel, 8, 4, 512, 512, 32, "bf16")
    flops = 2 * 32 * 512 * 512 * 32
    assert by == "operations"
    assert chip_smoke.PEAK_MIXED_FLOPS == pytest.approx(989e12 / 3)
    assert ms == pytest.approx(1e3 * flops * (stored / 989e12
                                              + mixed / (989e12 / 3)))


def test_bf16_storage_bytes_are_two_per_element():
    ms, by = chip_smoke.bound_ms("flash_bwd_dq", 1, 1, 1, 1, 16, "bf16")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * 5 * 16 + 4 * 2) / 3.35e12)


@pytest.mark.parametrize("largest,limit", [
    (1.0, 2e-4 + 2 ** -7), (0.75, 2e-4 + 2 ** -8), (3.9, 2e-4 + 2 ** -6),
    (0.0, 2e-4)])
def test_bf16_gradient_limit_adds_one_ulp(largest, limit):
    assert chip_smoke.grad_limit_bf16(largest) == pytest.approx(limit)


def test_crash_injection_raises_after_its_calls():
    aug = chip_smoke.crashing(lambda g, b: b, 2)
    assert aug(None, 1) == 1 and aug(None, 2) == 2
    with pytest.raises(chip_smoke.InjectedCrash, match="call 3"):
        aug(None, 3)


def test_bound_of_a_tiny_call_is_its_bytes():
    ms, by = chip_smoke.bound_ms("flash_fwd", 1, 1, 1, 1, 16)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * (4 * 16 + 1) / 3.35e12)


def _full_build(hmma: int = 1, spills: tuple = (0, 0)):
    """(resources, hmma) of a build with every instance of every kernel on
    the tensor cores, as parse_ptxas and count_hmma return them."""
    instances = [(k, d, s, o) for k in chip_smoke.MMA_KERNELS
                 for d in (16, 32, 64, 128) for s in ("f32", "bf16")
                 for o in ("f32", "bf16")]
    return ({i: (200, *spills) for i in instances},
            {i: hmma for i in instances})


def test_tensor_core_gate_passes_a_full_build():
    assert chip_smoke.tensor_core_faults(*_full_build()) == []


def test_tensor_core_gate_fails_a_missing_instance():
    resources, hmma = _full_build()
    inst = ("flash_bwd_dq", 64, "bf16", "f32")
    del hmma[inst]
    faults = chip_smoke.tensor_core_faults(resources, hmma)
    assert len(faults) == 1 and "missing" in faults[0]
    assert str(inst) in faults[0]


def test_tensor_core_gate_fails_an_instance_without_hmma():
    """The old K3 of canned ptxas and SASS text: no HMMA, so the gate
    fails, naming it."""
    resources, hmma = _full_build()
    inst = ("flash_bwd_dq", 16, "f32", "bf16")
    resources.update(chip_smoke.parse_ptxas(PTXAS))
    hmma.update(chip_smoke.count_hmma(SASS))
    faults = chip_smoke.tensor_core_faults(resources, hmma)
    # the canned K2 spills only at D=128, which the gate allows
    assert len(faults) == 1 and "no HMMA" in faults[0]
    assert str(inst) in faults[0]


def test_tensor_core_gate_fails_spills_at_d32():
    resources, hmma = _full_build()
    inst = ("flash_bwd_dq", 32, "f32", "f32")
    resources[inst] = (255, 8, 0)
    faults = chip_smoke.tensor_core_faults(resources, hmma)
    assert len(faults) == 1 and "spills at D=32" in faults[0]
    assert str(inst) in faults[0]


def test_tensor_core_gate_allows_spills_away_from_d32():
    resources, hmma = _full_build()
    resources[("flash_bwd_dq", 128, "f32", "f32")] = (255, 96, 96)
    assert chip_smoke.tensor_core_faults(resources, hmma) == []


def test_s1_bound_is_its_bytes_at_the_featurizer_shape():
    """x read and y written once, the (S, 2, M) state read: 5.9 MB over
    3.35 TB/s; the 9·S·T·M operations take less at 67 TFLOP/s."""
    ms, by = chip_smoke.s1_bound_ms(2554, 288, 4, True, False)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * (2 * 2554 * 288 + 2 * 4 * 288)
                               / 3.35e12)
    assert chip_smoke.s1_bound_ms(50, 90, 4, True, True)[0] == pytest.approx(
        1e3 * 4 * (2 * 50 * 90 + 2 * 2 * 4 * 90) / 3.35e12)


@pytest.mark.parametrize("kernels,n,ms,count", [
    ([(50, 500.0)], 50, 0.010, 1),                 # a whole trace
    ([(48, 480.0)], 50, 0.010, 1),                 # two launches lost
    ([(50, 500.0), (49, 147.0), (50, 400.0)], 50, 0.021, 3),   # S1's three
    ([(100, 300.0), (1, 9.0)], 50, 0.006, 2),      # twice a call; a stray
])
def test_device_time_per_call_survives_lost_launches(kernels, n, ms, count):
    got_ms, got_count = chip_smoke.per_call_device_ms(kernels, n)
    assert got_ms == pytest.approx(ms) and got_count == count


def test_device_profile_reports_an_empty_trace_as_not_measured(
        monkeypatch, capsys):
    """Where every trace comes back without a kernel (here: no card), the
    device time is not measured: (None, None), no other clock in its place,
    and the callers print "not measured" for it and for the ratios it
    enters."""
    import torch

    monkeypatch.setattr(chip_smoke.time, "sleep", lambda s: None)
    for name, value in (("synchronize", lambda: None),
                        ("empty_cache", lambda: None),
                        ("mem_get_info", lambda: (1, 2)),
                        ("memory_reserved", lambda: 0)):
        monkeypatch.setattr(torch.cuda, name, value)
    calls = []
    assert chip_smoke.device_profile(lambda: calls.append(1), n=2,
                                     attempts=2) == (None, None)
    assert len(calls) == 3 + 2 * 2
    out = capsys.readouterr().out
    assert out.count("no device time in a trace") == 2
    assert "not measured" in out
    assert chip_smoke._ms(None) == "not measured"
    assert chip_smoke.share(0.1, None) == "not measured"
    assert chip_smoke.share(None, 2.0, ".3f") == "not measured"
    assert chip_smoke.share(0.1, 0.4) == "25.0%"


def _pooled(x, pinned=None):
    """``max_pool_time`` of the encoders under ``pooling_recorded``: the
    output, the gradient of its sum and the recordings."""
    from multimodal_eeg_fmri_tpu_torch.models import encoders

    x = x.clone().requires_grad_(True)
    with chip_smoke.pooling_recorded([], pinned) as calls:
        out = encoders.max_pool_time(x, 2)
    out.sum().backward()
    return out.detach(), x.grad, calls


def test_pooling_recorded_is_the_pool_and_restores_it():
    import torch
    import torch.nn.functional as F

    from multimodal_eeg_fmri_tpu_torch.models import encoders

    real = encoders.max_pool_time
    x = torch.randn(3, 9, 4, generator=torch.Generator().manual_seed(0))
    out, grad, calls = _pooled(x)
    assert encoders.max_pool_time is real
    want = x.clone().requires_grad_(True)
    F.max_pool1d(want.transpose(1, 2), 2).transpose(1, 2).sum().backward()
    assert torch.equal(out, real(x, 2)) and torch.equal(grad, want.grad)
    (gap, idx), = calls
    assert idx.shape == (3, 4, 4) and gap.shape == (3, 4, 4)
    assert (gap > 0).all()


def test_pinned_pool_takes_the_recorded_element_of_a_tie():
    import torch

    x = torch.zeros(1, 4, 1)
    x[0, 1, 0] = 1.0                     # pair 0 no tie, pair 1 a tie
    _, grad, mine = _pooled(x)
    assert grad[0, :, 0].tolist() == [0.0, 1.0, 1.0, 0.0]
    assert mine[0][0][0, 0].tolist() == [1.0, 0.0]
    flipped = [(mine[0][0], mine[0][1].clone())]
    flipped[0][1][0, 0, 1] = 3           # the tie broken the other way
    out, grad, _ = _pooled(x, pinned=flipped)
    assert out[0, :, 0].tolist() == [1.0, 0.0]
    assert grad[0, :, 0].tolist() == [0.0, 1.0, 0.0, 1.0]
    assert chip_smoke.print_pool_flips("", mine, flipped) == 1


def test_pool_flip_at_a_pair_that_is_no_tie_fails():
    import torch

    x = torch.zeros(1, 4, 1)
    x[0, 1, 0] = 1.0
    _, _, mine = _pooled(x)
    other = [(mine[0][0], mine[0][1].clone())]
    other[0][1][0, 0, 0] = 0             # pair 0 (gap 1 of 1) chosen otherwise
    with pytest.raises(SystemExit, match="no tie"):
        chip_smoke.print_pool_flips("", mine, other)
    with pytest.raises(SystemExit, match="pinned max-pool indices"):
        _pooled(torch.zeros(2, 4, 1), pinned=mine)


# the split K1, K2 and K3 past head dim 128 (csrc/flash_fwd_split.cu,
# csrc/flash_bwd_split.cu), as nvcc mangles them: a kernel of one Params
# argument
SPLIT_DKV = ("_ZN51_GLOBAL__N__a97f168f_18_flash_bwd_split_cu_04c0686e26flash_"
             "bwd_dkv_split_kernelILi256EfLb0EEEvNS_6ParamsE")
SPLIT_DQ = ("_ZN51_GLOBAL__N__a97f168f_18_flash_bwd_split_cu_04c0686e25flash_"
            "bwd_dq_split_kernelILi192E13__nv_bfloat16Lb1EEEvNS_6ParamsE")
SPLIT_FWD = ("_ZN51_GLOBAL__N__aa792df0_18_flash_fwd_split_cu_c33b2bdc22flash_"
             "fwd_split_kernelILi256EfLb0EEEvNS_6ParamsE")
SPLIT_FWD_BF16 = ("_ZN51_GLOBAL__N__aa792df0_18_flash_fwd_split_cu_c33b2bdc22"
                  "flash_fwd_split_kernelILi192E13__nv_bfloat16Lb1EEEvNS_"
                  "6ParamsE")


@pytest.mark.parametrize("symbol,instance", [
    (SPLIT_DKV, ("flash_bwd_dkv_split", 256, "f32", "f32")),
    (SPLIT_DQ, ("flash_bwd_dq_split", 192, "bf16", "bf16")),
    (SPLIT_FWD, ("flash_fwd_split", 256, "f32", "f32")),
    (SPLIT_FWD_BF16, ("flash_fwd_split", 192, "bf16", "bf16")),
    (DKV, None),
    (FWD, None),
])
def test_split_instance_reads_mangled_symbols(symbol, instance):
    assert chip_smoke.split_instance(symbol) == instance
    if instance is not None:
        assert chip_smoke.kernel_instance(symbol) is None


def test_split_instances_in_ptxas_and_sass():
    text = f"""ptxas info    : Compiling entry function '{SPLIT_DKV}' for 'sm_90a'
ptxas info    : Function properties for {SPLIT_DKV}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers, 528 bytes cmem[0]
"""
    sass = f"""\t\tFunction : {SPLIT_DKV}
        /*1230*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""
    inst = ("flash_bwd_dkv_split", 256, "f32", "f32")
    assert chip_smoke.parse_ptxas(text + PTXAS, chip_smoke.split_instance) == {
        inst: (178, 0, 0, 0)}
    assert chip_smoke.count_hmma(sass + SASS, chip_smoke.split_instance) == {
        inst: 1}


def test_forward_split_instances_in_ptxas_and_sass():
    """K1's split instances are read from ptxas and SASS beside K2's, and
    not as the tensor-core K1 up to 128."""
    text = f"""ptxas info    : Compiling entry function '{SPLIT_FWD}' for 'sm_90a'
ptxas info    : Function properties for {SPLIT_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 228 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '{SPLIT_DKV}' for 'sm_90a'
ptxas info    : Function properties for {SPLIT_DKV}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers, 528 bytes cmem[0]
"""
    sass = f"""\t\tFunction : {SPLIT_FWD}
        /*1230*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*1240*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;
\t\tFunction : {SPLIT_DKV}
        /*1230*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""
    fwd = ("flash_fwd_split", 256, "f32", "f32")
    dkv = ("flash_bwd_dkv_split", 256, "f32", "f32")
    assert chip_smoke.parse_ptxas(text, chip_smoke.split_instance) == {
        fwd: (228, 0, 0, 0), dkv: (178, 0, 0, 0)}
    assert chip_smoke.count_hmma(sass, chip_smoke.split_instance) == {
        fwd: 2, dkv: 1}
    assert chip_smoke.parse_ptxas(text) == {}


def _split_build():
    instances = [(k, d, s, o) for k in chip_smoke.SPLIT_KERNELS
                 for d in chip_smoke.SPLIT_DIMS for s in ("f32", "bf16")
                 for o in ("f32", "bf16")]
    return {i: (178, 0, 0, 0) for i in instances}, dict.fromkeys(instances, 8)


def _gate(kind, resources, hmma):
    """``instance_faults`` with the split or the deep instances."""
    wanted = {"split": chip_smoke.SPLIT_INSTANCES,
              "deep": chip_smoke.DEEP_INSTANCES}[kind]
    return chip_smoke.instance_faults(wanted, resources, hmma, kind)


def test_split_gate_passes_a_full_build():
    assert _gate("split", *_split_build()) == []


@pytest.mark.parametrize("fault", ["missing", "no HMMA", "spill", "stack"])
def test_split_gate_names_the_faulty_instance(fault):
    """No split instance may be missing, lack HMMA, spill or keep a stack
    frame."""
    resources, hmma = _split_build()
    inst = ("flash_bwd_dq_split", 192, "bf16", "f32")
    if fault == "missing":
        del resources[inst]
    elif fault == "no HMMA":
        hmma[inst] = 0
    else:
        resources[inst] = ((255, 8, 8, 0) if fault == "spill"
                           else (200, 0, 0, 16))
    faults = _gate("split", resources, hmma)
    assert len(faults) == 1 and str(inst) in faults[0]


# past 256, K2 and K3's route at each head dim: the deep kernels at d padded
# to a multiple of 64
DEEP_ROUTES = {257: "_deep D=320", 320: "_deep D=320", 512: "_deep D=512",
               1000: "_deep D=1024"}


@pytest.mark.parametrize("d,route", [(160, "_split D=192"),
                                     (192, "_split D=192"),
                                     (256, "_split D=256"),
                                     (320, "_wide D=320"),
                                     (257, "_wide D=257"),
                                     (512, "_wide D=512"),
                                     (1000, "_wide D=1000")])
def test_wide_instances_name_the_route_of_each_head_dim(d, route):
    """K1, K2 and K3 take one route at each head dim past 128: the split
    kernels at the padded instance up to 256 (``route``); past it K1 the
    CUDA-core kernel at d (``route``), K2 and K3 the deep tensor-core
    kernels at d padded to a multiple of 64."""
    bwd = DEEP_ROUTES.get(d, route)
    assert chip_smoke.wide_instances(d) == {
        "flash_fwd": f"mmef_flash_fwd{route}",
        "flash_bwd_dkv": f"mmef_flash_bwd_dkv{bwd}",
        "flash_bwd_dq": f"mmef_flash_bwd_dq{bwd}"}
    for name, entry in chip_smoke.wide_instances(d).items():
        kernel = chip_smoke.wide_route(name, d)
        assert kernel.endswith(entry.split(" ")[0].rsplit("_", 1)[1])


# the CUDA-core K1 and the deep K2 and K3 past head dim 256
# (csrc/flash_wide.cu, csrc/flash_bwd_deep.cu), as nvcc mangles them
WIDE_FWD = ("_ZN12_GLOBAL__N_121flash_wide_fwd_kernelI13__nv_bfloat16Lb1EEEvPKT_"
            "S4_S4_PS2_Pfiiiiillllllllllf")
DEEP_DKV = ("_ZN51_GLOBAL__N__0c1d2e3f_17_flash_bwd_deep_cu_4a5b6c7d25flash_"
            "bwd_dkv_deep_kernelIfLb0EEEvNS_6ParamsE")
DEEP_DQ = ("_ZN51_GLOBAL__N__0c1d2e3f_17_flash_bwd_deep_cu_4a5b6c7d24flash_"
           "bwd_dq_deep_kernelI13__nv_bfloat16Lb1EEEvNS_6ParamsE")


@pytest.mark.parametrize("symbol,wide,deep", [
    (WIDE_FWD, ("flash_fwd_wide", "bf16", "bf16"), None),
    (DEEP_DKV, None, ("flash_bwd_dkv_deep", "f32", "f32")),
    (DEEP_DQ, None, ("flash_bwd_dq_deep", "bf16", "bf16")),
    (SPLIT_DKV, None, None),
    (DKV, None, None),
])
def test_wide_and_deep_instances_read_mangled_symbols(symbol, wide, deep):
    """The CUDA-core K1 and the deep K2 and K3 are told apart from each
    other and from the split and D ≤ 128 kernels."""
    assert chip_smoke.wide_instance(symbol) == wide
    assert chip_smoke.deep_instance(symbol) == deep
    if wide or deep:
        assert chip_smoke.kernel_instance(symbol) is None
        assert chip_smoke.split_instance(symbol) is None


def test_deep_instances_in_ptxas_and_sass():
    text = f"""ptxas info    : Compiling entry function '{DEEP_DKV}' for 'sm_90a'
ptxas info    : Function properties for {DEEP_DKV}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 214 registers, used 1 barriers, 520 bytes cmem[0]
"""
    sass = f"""\t\tFunction : {DEEP_DKV}
        /*1230*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""
    inst = ("flash_bwd_dkv_deep", "f32", "f32")
    assert chip_smoke.parse_ptxas(text + PTXAS, chip_smoke.deep_instance) == {
        inst: (214, 0, 0, 0)}
    assert chip_smoke.count_hmma(sass + SASS, chip_smoke.deep_instance) == {
        inst: 1}


def _deep_build():
    instances = sorted(chip_smoke.DEEP_INSTANCES)
    assert len(instances) == 8
    return {i: (190, 0, 0, 0) for i in instances}, dict.fromkeys(instances, 8)


def test_deep_gate_passes_a_full_build():
    assert _gate("deep", *_deep_build()) == []


@pytest.mark.parametrize("fault", ["missing", "no HMMA", "spill", "stack"])
def test_deep_gate_names_the_faulty_instance(fault):
    """No deep instance may be missing, lack HMMA, spill or keep a stack
    frame."""
    resources, hmma = _deep_build()
    inst = ("flash_bwd_dq_deep", "bf16", "f32")
    if fault == "missing":
        del resources[inst]
    elif fault == "no HMMA":
        hmma[inst] = 0
    else:
        resources[inst] = ((255, 8, 8, 0) if fault == "spill"
                           else (200, 0, 0, 16))
    faults = _gate("deep", resources, hmma)
    assert len(faults) == 1 and str(inst) in faults[0]


def test_split_gate_wants_the_forward_instances():
    """A build whose split K1 instances are missing fails, naming all
    eight (D 192 and 256, f32 and bf16 storage, f32 and bf16 operands)."""
    resources, hmma = _split_build()
    forward = sorted(i for i in resources if i[0] == "flash_fwd_split")
    assert len(forward) == 8
    for inst in forward:
        del resources[inst], hmma[inst]
    (fault,) = _gate("split", resources, hmma)
    assert all(str(inst) in fault for inst in forward)


@pytest.mark.parametrize("fault", ["no HMMA", "spill", "stack"])
def test_split_gate_names_a_faulty_forward_instance(fault):
    """A split K1 instance with no HMMA, a spill or a stack frame fails."""
    resources, hmma = _split_build()
    inst = ("flash_fwd_split", 256, "f32", "bf16")
    if fault == "no HMMA":
        hmma[inst] = 0
    else:
        resources[inst] = ((255, 8, 8, 0) if fault == "spill"
                           else (200, 0, 0, 16))
    faults = _gate("split", resources, hmma)
    assert len(faults) == 1 and str(inst) in faults[0]
