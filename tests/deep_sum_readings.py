"""Readings behind the deep kernels' score sums (not a test; needs a card).

For each head dim, on one seeded (1, 1, T, D) f32 case (T = 64 unless
the argument is D:T): the largest
distance of K1's output and lse, K2's dK and dV and K3's dQ from their
plain versions and from the float64 computation of the same inputs (the
plain versions' own distance from float64 beside it), then the time of one
call of each kernel (CUDA events around 50 calls) at the deep kernels'
timed shapes. A head dim the wrappers refuse is reported as refused, so
the script also reads a checkout from before a change:

    python tests/deep_sum_readings.py [d[:t] ...]
    (cd OTHER_CHECKOUT && PYTHONPATH=. python /path/to/deep_sum_readings.py)

(default d = 320, 512, 1024, 2048, 4096, 8192 and 12800). It prints the
card's name and power limit first.
"""

import subprocess
import sys

import numpy as np
import torch

from multimodal_eeg_fmri_tpu_torch.ops.attention import (
    flash_bwd_dkv_cuda,
    flash_bwd_dkv_plain,
    flash_bwd_dq_cuda,
    flash_bwd_dq_plain,
    flash_delta,
    flash_forward_cuda,
    flash_forward_plain,
)

DIMS = (320, 512, 1024, 2048, 4096, 8192, 12800)
TIMED = ((8, 4, 512, 320), (8, 4, 512, 512), (8, 1, 2048, 512),
         (1, 1, 64, 12800))


def _err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def errors(d: int, dev, t: int = 64) -> str:
    r = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(r.standard_normal(
        (1, 1, t, d), dtype=np.float32)).to(dev) for _ in range(4))
    ok, lk = flash_forward_cuda(q, k, v)
    op, lp = flash_forward_plain(q, k, v)
    delta = flash_delta(op, g)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lp, delta)
    dq = flash_bwd_dq_cuda(q, k, v, g, lp, delta)
    pk, pv = flash_bwd_dkv_plain(q, k, v, g, lp, delta)
    pq = flash_bwd_dq_plain(q, k, v, g, lp, delta)
    # float64 from the same inputs (the backward from the plain lse and Δ)
    Q, K, V, G = (t.double() for t in (q, k, v, g))
    scale = d ** -0.5
    S = Q @ K.transpose(-1, -2) * scale
    o64, l64 = torch.softmax(S, -1) @ V, torch.logsumexp(S, -1)
    P = torch.exp(S - lp.double()[..., None])
    dS = P * (G @ V.transpose(-1, -2) - delta.double()[..., None])
    ev, ek, eq = P.transpose(-1, -2) @ G, dS.transpose(-1, -2) @ Q * scale, \
        dS @ K * scale
    return (f"D={d} T={t}: K1 vs plain out {_err(ok, op):.2e} lse {_err(lk, lp):.2e};"
            f" vs f64 kernel out {_err(ok, o64):.2e} lse {_err(lk, l64):.2e},"
            f" plain out {_err(op, o64):.2e} lse {_err(lp, l64):.2e} | K2 vs "
            f"plain {max(_err(dk, pk), _err(dv, pv)):.2e}; vs f64 kernel "
            f"{max(_err(dk, ek), _err(dv, ev)):.2e}, plain "
            f"{max(_err(pk, ek), _err(pv, ev)):.2e} | K3 vs plain "
            f"{_err(dq, pq):.2e}; vs f64 kernel {_err(dq, eq):.2e}, plain "
            f"{_err(pq, eq):.2e}")


def _ms(fn, n: int = 50) -> float:
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def times(shape, dev) -> str:
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(*shape, device=dev, generator=gen)
                  for _ in range(4))
    o, lse = flash_forward_cuda(q, k, v)
    delta = flash_delta(o, g)
    t1 = _ms(lambda: flash_forward_cuda(q, k, v))
    t2 = _ms(lambda: flash_bwd_dkv_cuda(q, k, v, g, lse, delta))
    t3 = _ms(lambda: flash_bwd_dq_cuda(q, k, v, g, lse, delta))
    return f"{shape}: K1 {t1:.4f} K2 {t2:.4f} K3 {t3:.4f} ms"


def main(dims) -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    for d, t in dims:
        try:
            print(errors(d, dev, t), flush=True)
        except ValueError as e:
            print(f"D={d}: refused ({e})", flush=True)
    for shape in TIMED:
        try:
            print(times(shape, dev), flush=True)
        except ValueError as e:
            print(f"{shape}: refused ({e})", flush=True)


if __name__ == "__main__":
    main([tuple(int(n) for n in (a + ":64").split(":")[:2])
          for a in sys.argv[1:]] or [(d, 64) for d in DIMS])
