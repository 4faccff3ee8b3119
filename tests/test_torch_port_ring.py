"""The port's ring attention (``ops/ring_attention.py``) against the JAX
package's, as ``tests/test_ring_attention.py`` runs it.

The JAX side runs here on its 8-device CPU mesh (the flash chunk in
interpret mode); the port side in a world of 8 spawned gloo ranks whose
workers import no JAX (``test_torch_port_workers.py``), one world for every case,
module-scoped. Same inputs, made from a seed with numpy; each rank's output
and gradient blocks are put back together in mesh order. Cases: the einsum
and the flash chunk, f32 and bf16 compute, T = 64 (T_local 8) and 256, the
extreme-logit case (q × 20) and the head-sharded (seq 4 × model 2) mesh:
the output within 2e-5 and the gradients of sum(out · g) within 5e-5 of
JAX's (relative as well, as the JAX tests hold them to the reference);
bf16 compute against JAX's bf16 ring within 2e-3, half of bf16's unit
roundoff (the packages round p to bf16 against other running maxima: the
flash chunk's dv parts by 9.4e-4, the einsum chunk's by 3e-5). And the
refusals: a custom scale on the flash chunk, a T the
ring does not divide, a ring size other than the axis's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from multimodal_eeg_fmri_tpu.ops.ring_attention import (
    ring_attention as j_ring,
    shard_sequence as j_shard,
)
from multimodal_eeg_fmri_tpu_torch.parallel import spawn_local_world

import test_torch_port_workers as workers

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
BF16_TOL = 2e-3        # half of bf16's unit roundoff 2^-8

# name: (B, H, T, D, seed, q scale, mesh shape, axis names, seq axis,
#        head axis, impl, compute dtype)
CASES = {
    "einsum": (2, 2, 64, 16, 0, 1.0, (8,), ("data",), "data", None,
               "einsum", "float32"),
    "flash": (2, 2, 256, 16, 5, 1.0, (8,), ("data",), "data", None,
              "flash", "float32"),
    "flash_T64": (2, 2, 64, 16, 1, 1.0, (8,), ("data",), "data", None,
                  "flash", "float32"),
    "einsum_bf16": (2, 2, 64, 16, 2, 1.0, (8,), ("data",), "data", None,
                    "einsum", "bfloat16"),
    "flash_bf16": (2, 2, 64, 16, 4, 1.0, (8,), ("data",), "data", None,
                   "flash", "bfloat16"),
    "extreme_logits": (2, 2, 64, 16, 3, 20.0, (8,), ("data",), "data", None,
                       "einsum", "float32"),
    "extreme_logits_flash": (2, 2, 64, 16, 3, 20.0, (8,), ("data",), "data",
                             None, "flash", "float32"),
    "head_sharded": (2, 4, 64, 16, 9, 1.0, (4, 2), ("seq", "model"), "seq",
                     "model", "einsum", "float32"),
    "head_sharded_flash": (2, 4, 64, 16, 9, 1.0, (4, 2), ("seq", "model"),
                           "seq", "model", "flash", "float32"),
}


def _arrays(B, H, T, D, seed, q_scale):
    r = np.random.default_rng(seed)
    q, k, v, g = (r.normal(size=(B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    return q * np.float32(q_scale), k, v, g


def _jax_ring(case):
    B, H, T, D, seed, qs, shape, names, seq, heads, impl, cdt = case
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(shape), names)
    q, k, v, g = _arrays(B, H, T, D, seed, qs)

    def loss(q, k, v):
        out = j_ring(q, k, v, mesh, axis=seq, head_axis=heads, impl=impl,
                     compute_dtype=jnp.dtype(cdt), interpret=True)
        return jnp.sum(out * g), out

    sharded = [j_shard(jnp.asarray(x), mesh, axis=seq, head_axis=heads)
               for x in (q, k, v)]
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*sharded)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _assemble(case, blocks):
    """The (B, H, T, D) array from each rank's block, rank r at its place
    in the mesh (row-major over the mesh's axes)."""
    B, H, T, D, _, _, shape, names, seq, heads = case[:10]
    full = np.zeros((B, H, T, D), np.float32)
    for rank, blk in enumerate(blocks):
        coords = dict(zip(names, np.unravel_index(rank, shape)))
        t0 = coords[seq] * blk.shape[2]
        h0 = coords[heads] * blk.shape[1] if heads else 0
        full[:, h0:h0 + blk.shape[1], t0:t0 + blk.shape[2]] = (
            blk.float().numpy())
    return full


@pytest.fixture(scope="module")
def port_runs():
    """Every case in one world of 8 gloo ranks."""
    cases = []
    for case in CASES.values():
        B, H, T, D, seed, qs, shape, names, seq, heads, impl, cdt = case
        cases.append((shape, names, seq, heads, impl, cdt,
                      *_arrays(B, H, T, D, seed, qs)))
    ranks = spawn_local_world(workers.ring_attention_cases, 8, cases)
    assert not any(jax_loaded for *_, jax_loaded in ranks)
    runs = {name: [_assemble(case, [r[0][i][j] for r in ranks])
                   for j in range(4)]
            for i, (name, case) in enumerate(CASES.items())}
    runs["refusals"] = [r[1] for r in ranks]
    return runs


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_attention_matches_jax(port_runs, name):
    case = CASES[name]
    want = _jax_ring(case)
    got = port_runs[name]
    bf16 = case[-1] == "bfloat16"
    for what, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        tol = BF16_TOL if bf16 else tol
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol,
                                   err_msg=f"{name} {what}")
    assert np.all(np.isfinite(got[0]))


def test_ring_refusals(port_runs):
    """A custom scale on the flash chunk (JAX: "fixed 1/sqrt"), a T that
    does not divide the ring ("not divisible"), a ring size other than the
    axis's: each raises ValueError on every rank of the 8-rank world."""
    for msgs in port_runs["refusals"]:
        assert "fixed 1/sqrt" in msgs[0]
        assert "T=31 not divisible by ring size 8" in msgs[1]
        assert "ring_size=9" in msgs[2]
    q = jnp.zeros((1, 1, 31, 8))
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    with pytest.raises(ValueError, match="not divisible"):
        j_ring(q, q, q, mesh)
