"""Readings behind bf16 storage at head dims past 256 (not a test).

For each head dim and seed, on the inputs of
``test_torch_port_head_dims.py``'s bf16-storage tests: the share of
elements where the port's bf16 output, dQ and dK differ from the JAX
package's; the rows where the two round Δ = rowsum(dO ⊙ O) to different
bf16 values; and each package's largest distance, in bf16 ulps, of dQ and
dK from the float64 backward of the same bf16 inputs given that package's
own Δ, with its mean distance as a share of the tensor's largest element.

    JAX_PLATFORMS=cpu python tests/bf16_storage_readings.py [d ...]

(default d = 320 and 512; seeds d + 7, 1, 2, 3).
"""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_port_head_dims import (  # noqa: E402
    _bf16_ulps,
    _wide_sizes,
    jax_attn,
    port_attn,
)


def _jax_side(q, k, v, g):
    """JAX's bf16 output, gradients and Δ, compiled without excess
    precision as the tests compile them."""
    def run(q, k, v, g):
        (out, lse), vjp = jax.vjp(lambda q, k, v: jax_attn.flash_attention_lse(
            q, k, v, interpret=True), q, k, v)
        grads = vjp((g, jnp.zeros_like(lse)))
        return out, grads, jnp.sum(out * g, axis=-1).astype(jnp.float32)

    out, grads, delta = jax.jit(run).lower(q, k, v, g).compile(
        compiler_options={"xla_allow_excess_precision": False})(q, k, v, g)
    as_torch = [torch.tensor(np.asarray(x.astype(jnp.float32)))
                for x in (out, *grads)]
    return as_torch, torch.tensor(np.asarray(delta))


def readings(d: int, seed: int) -> str:
    r = np.random.default_rng(seed)
    B, H, tq, tk = _wide_sizes(d)
    q, k, v, g = (jnp.asarray(r.standard_normal(s, dtype=np.float32))
                  .astype(jnp.bfloat16) for s in
                  ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                   (B, H, tq, d)))
    (out_j, dq_j, dk_j, _), delta_j = _jax_side(q, k, v, g)
    leaves = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
              for x in (q, k, v, g)]
    qkv = [x.clone().requires_grad_() for x in leaves[:3]]
    out_p, _ = port_attn.flash_attention_lse(*qkv)
    dq_p, dk_p, _ = torch.autograd.grad(out_p, qkv, leaves[3])
    out_p = out_p.detach()
    delta_p = port_attn.flash_delta(out_p, leaves[3])

    Q, K, V, G = (x.double() for x in leaves)
    scale = 1.0 / math.sqrt(d)
    p = torch.softmax(Q @ K.transpose(-1, -2) * scale, dim=-1)

    def f64_grads(delta):
        ds = p * (G @ V.transpose(-1, -2) - delta.double()[..., None])
        return ds @ K * scale, ds.transpose(-1, -2) @ Q * scale

    def distance(x, ref):
        return (f"{_bf16_ulps(x, ref).max().item():.3f} ulp, mean "
                f"{((x.double() - ref).abs().mean() / ref.abs().max()).item():.4e}")

    ref_p, ref_j = f64_grads(delta_p), f64_grads(delta_j)
    differ = {name: (a.float() != b).double().mean().item() for name, a, b in
              (("out", out_p, out_j), ("dq", dq_p, dq_j), ("dk", dk_p, dk_j))}
    return (f"d={d} seed={seed}: port != JAX on "
            + ", ".join(f"{n} {v:.2%}" for n, v in differ.items())
            + f"; Δ differs on {int((delta_p != delta_j).sum())} of "
            f"{delta_p.numel()} rows; from float64 given its own Δ: port dq "
            f"{distance(dq_p, ref_p[0])}, dk {distance(dk_p, ref_p[1])}; "
            f"JAX dq {distance(dq_j, ref_j[0])}, dk {distance(dk_j, ref_j[1])}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    for d in [int(a) for a in sys.argv[1:]] or [320, 512]:
        for seed in (d + 7, 1, 2, 3):
            print(readings(d, seed), flush=True)
