"""``chip_smoke.py``'s readers of compiler output, and its bound, on the CPU.

The script itself needs a GPU. These helpers parse text and do arithmetic,
so they are held here to canned output in the formats of ``nvcc -Xptxas -v``
and ``cuobjdump -sass``.
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


S1 = "_ZN12_GLOBAL__N_114sosfilt_kernelILi4EEEvPKfPfS2_S3_NS_6CoeffsEiii"


def test_parse_ptxas_reads_s1_instances_by_sections():
    text = PTXAS + f"""ptxas info    : Compiling entry function '{S1}' for 'sm_90a'
ptxas info    : Function properties for {S1}
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 3488 bytes cmem[0]
"""
    assert chip_smoke.s1_instance(S1) == ("sosfilt", 4)
    assert chip_smoke.s1_instance(FWD) is None
    assert chip_smoke.parse_ptxas(text, chip_smoke.s1_instance) == {
        ("sosfilt", 4): (80, 0, 0, 8)}
    assert ("sosfilt", 4) not in chip_smoke.parse_ptxas(text)


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
