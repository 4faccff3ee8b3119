"""``MoEFFN`` on the card at the lc-moe cell's shape: x (8, 2048, 64), 4
experts, top-2, capacity factor 2.0 (S = 16,384 tokens, C = 8,192 slots an
expert).

Two forward and backward runs give the same bits (the index route's
gradients gather by the inverse map; nothing accumulates through atomics),
and one layer's forward and backward peak under 1 GB of device memory (the
dense (S, E, C) dispatch and combine tensors were 2.1 GB each). Marked
``cuda``, skipped without a card; imports no JAX:

    python -m pytest --noconftest -s -m cuda tests/test_torch_port_moe_card.py
"""

import pytest
import torch

from multimodal_eeg_fmri_tpu_torch.ops import moe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_layer_repeats_bit_for_bit_in_under_1gb(cuda_device):
    torch.manual_seed(0)
    layer = moe.MoEFFN(64, 4, top_k=2, capacity_factor=2.0,
                       device=cuda_device).train()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(8, 2048, 64, device=cuda_device, generator=gen)
    g = torch.randn(8, 2048, 64, device=cuda_device, generator=gen)

    def run():
        xx = x.clone().requires_grad_()
        with moe.collect_aux_losses() as sink:
            y = layer(xx)
        loss = (y * g).sum() + sink[0]
        grads = torch.autograd.grad(loss, (xx, *layer.parameters()))
        return (y.detach(), *grads)

    run()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    first = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device)
    second = run()
    torch.cuda.synchronize()
    names = ["y", "x"] + [n for n, _ in layer.named_parameters()]
    same = {n: torch.equal(a, b) for n, a, b in zip(names, first, second)}
    print(f"MoE layer forward and backward at (8, 2048, 64), E 4, top-2, "
          f"cf 2.0 on {torch.cuda.get_device_name(cuda_device)}: peak "
          f"{peak} bytes allocated; bit for bit on a second run: {same}")
    assert all(same.values()), same
    assert peak < 1e9, peak
