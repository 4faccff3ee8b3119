"""The port's ``parallel`` package and ``utils/tree`` against the JAX
package's.

- The collectives in a world of 8 spawned gloo ranks on a (4, 2)
  ("ensemble", "data") mesh (``test_torch_port_workers.collectives``, no JAX in
  the workers): ``psum`` over one axis and over both, ``pmean``, tiled
  ``all_gather``, ``ppermute_shift`` both ways and of a tree, each result and
  its gradient of sum(result · arange) against the JAX collectives under
  ``shard_map`` on the 8-device CPU mesh (``tests/test_collectives.py``'s
  semantics), exactly but for float sums within 1e-6; ``pmean_grads`` by
  dtype.
- ``process_fold_range``, ``build_mesh``'s and ``build_hybrid_mesh``'s
  layouts (the data axis inside a host), ``global_batch_tree`` and
  ``global_ensemble_tree`` (each rank's block equal to the addressable shard
  JAX puts on the device at its place in the mesh) and ``shard_sequence``
  against ``tests/test_distributed.py``; ``initialize_distributed`` a no-op
  in one process.
- ``count_parameters``, ``tree_size_bytes`` and ``cast_floating`` over a
  module, its state dict and nested arrays, against the JAX package's over
  the same variables.
- The package's names cover the JAX package's ``__all__`` and no message
  names queue A item 7c, 7d or 8 (``ensemble_vmap`` is among the names);
  a rank that fails fails its world.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_eeg_fmri_tpu.parallel import collectives as j_coll
from multimodal_eeg_fmri_tpu.parallel import distributed as j_dist
from multimodal_eeg_fmri_tpu.parallel import input as j_input
from multimodal_eeg_fmri_tpu.parallel import mesh as j_mesh
from multimodal_eeg_fmri_tpu.utils import tree as j_tree
from multimodal_eeg_fmri_tpu_torch import parallel as t_par
from multimodal_eeg_fmri_tpu_torch.utils import tree as t_tree

import test_torch_port_workers as workers

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

X = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)


def _jax_collective(name):
    """(per-rank results (8, ...), per-rank gradients (8, 3)) of one
    collective under JAX's shard_map, rank r holding X[r]."""
    plan = j_mesh.build_mesh(jax.devices()[:8], ensemble=4, data=2)
    E, D = j_mesh.ENSEMBLE_AXIS, j_mesh.DATA_AXIS
    fn = {
        "psum_data": lambda t: j_coll.psum(t, D),
        "psum_all": lambda t: j_coll.psum(t, (E, D)),
        "pmean_ensemble": lambda t: j_coll.pmean(t, E),
        "all_gather_ensemble": lambda t: j_coll.all_gather(t, E, axis=0),
        "ppermute_ensemble": lambda t: j_coll.ppermute_shift(t, E, 1),
        "ppermute_back": lambda t: j_coll.ppermute_shift(t, E, -1),
        "ppermute_tree": lambda t: sum(j_coll.ppermute_shift((t, 2 * t), D)),
    }[name]

    def body(x):                    # x: (1, 3), this device's row
        y = fn(x[0] if name != "all_gather_ensemble" else x)
        w = jnp.arange(y.size, dtype=y.dtype).reshape(y.shape)
        g = jax.grad(lambda x: jnp.sum(
            fn(x[0] if name != "all_gather_ensemble" else x) * w))(x)
        return y[None], g

    spec = P((E, D))
    # check_vma=False: psum transposes to psum, as in the JAX package's
    # ring (ops/ring_attention.py) and as the port's collectives do
    y, g = jax.jit(jax.shard_map(body, mesh=plan.mesh, in_specs=spec,
                                 out_specs=(spec, spec), check_vma=False))(
        jnp.asarray(X))
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module")
def port_collectives():
    ranks = t_par.spawn_local_world(workers.collectives, 8, X)
    assert not any(r[-1] for r in ranks)
    return ranks


@pytest.mark.parametrize("name", [
    "psum_data", "psum_all", "pmean_ensemble", "all_gather_ensemble",
    "ppermute_ensemble", "ppermute_back", "ppermute_tree"])
def test_collective_and_its_gradient_match_jax(port_collectives, name):
    want_y, want_g = _jax_collective(name)
    for rank, (results, *_rest) in enumerate(port_collectives):
        y, g = results[name]
        np.testing.assert_allclose(y.numpy().reshape(want_y[rank].shape),
                                   want_y[rank], rtol=0, atol=1e-6,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(g.numpy(), want_g[rank], rtol=0,
                                   atol=1e-6, err_msg=f"rank {rank}")


def test_pmean_grads_and_mesh_layout(port_collectives):
    """``pmean_grads`` over the data axis keeps each leaf's dtype (one
    reduction per dtype) and averages the pair of ranks of each row; the
    ranks sit at (r // 2, r % 2) of the (4, 2) mesh, as JAX's devices."""
    plan = j_mesh.build_mesh(jax.devices()[:8], ensemble=4, data=2)
    ids = np.vectorize(lambda d: d.id)(plan.mesh.devices)
    for rank, (_, grads, coords, n, _) in enumerate(port_collectives):
        assert n == 8
        assert (coords["ensemble"], coords["data"]) == tuple(
            np.argwhere(ids == rank)[0])
        pair = X[2 * (rank // 2): 2 * (rank // 2) + 2].mean(0)
        assert grads["a"].dtype == torch.float32
        assert grads["b"].dtype == torch.float64
        np.testing.assert_allclose(grads["a"].numpy(), pair, atol=1e-7)
        np.testing.assert_allclose(grads["b"].numpy(), pair, atol=1e-7)


def test_a_failing_rank_fails_its_world():
    with pytest.raises(Exception, match="ring_size=3"):
        t_par.spawn_local_world(workers.failing_rank, 2)


def test_initialize_single_process_noop_and_idempotent():
    assert t_par.initialize_distributed() == 1
    assert t_par.initialize_distributed() == 1
    assert j_dist.initialize_distributed() == 1


def test_process_fold_range_matches_jax():
    for n, procs in ((12, 4), (8, 2), (6, 1)):
        for p in range(procs):
            assert t_par.process_fold_range(
                n, process_index=p, num_processes=procs) == \
                j_input.process_fold_range(n, process_index=p,
                                           num_processes=procs)
    for mod in (t_par, j_input):
        with pytest.raises(ValueError, match="not divisible"):
            mod.process_fold_range(10, process_index=0, num_processes=4)
    assert t_par.process_fold_range(4) == (0, 4)


def test_build_mesh_layouts_match_jax():
    for ens, data in ((4, 2), (0, 2), (8, 0), (0, 0)):
        want = j_mesh.build_mesh(jax.devices()[:8], ensemble=ens, data=data)
        got = t_par.build_mesh(ensemble=ens, data=data, world_size=8)
        np.testing.assert_array_equal(
            got.mesh.ranks, np.vectorize(lambda d: d.id)(want.mesh.devices))
        assert (got.n_ensemble, got.n_data, got.n_devices) == (
            want.n_ensemble, want.n_data, want.n_devices)
    with pytest.raises(ValueError, match="!= 8 devices"):
        t_par.build_mesh(ensemble=3, data=2, world_size=8)


def test_hybrid_mesh_keeps_data_axis_inside_a_host():
    """Two hosts of 4 ranks: each data row inside one host, the ensemble
    axis across both (the JAX test's FakeDev layout); one host falls back
    to the flat mesh; a data axis wider than a host raises."""
    plan = t_par.build_hybrid_mesh(ensemble=4, data=2, ranks_per_host=4,
                                   world_size=8)
    arr = plan.mesh.ranks
    assert arr.shape == (4, 2)
    for row in arr:
        assert len({r // 4 for r in row}) == 1
    assert {r // 4 for r in arr[:, 0]} == {0, 1}
    flat = t_par.build_hybrid_mesh(ensemble=4, data=2, world_size=8)
    np.testing.assert_array_equal(flat.mesh.ranks, np.arange(8).reshape(4, 2))
    with pytest.raises(ValueError, match="inside a host"):
        t_par.build_hybrid_mesh(ensemble=1, data=8, ranks_per_host=4,
                                world_size=8)
    with pytest.raises(ValueError, match="!= 8 devices"):
        t_par.build_hybrid_mesh(ensemble=3, data=2, ranks_per_host=4,
                                world_size=8)


def _shard_of(arr, mesh, rank):
    """The addressable shard JAX put on device ``rank``."""
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device.id == rank)


def test_local_trees_match_jax_shards():
    r = np.random.default_rng(1)
    tree = {"x": r.standard_normal((8, 6, 5)).astype(np.float32),
            "y": r.standard_normal((8, 6)).astype(np.float32)}
    jplan = j_mesh.build_mesh(jax.devices()[:8], ensemble=4, data=2)
    jbatch = j_mesh.shard_batch(jplan, tree)
    jens = j_mesh.shard_ensemble_tree(jplan, tree)
    for rank in range(8):
        plan = t_par.build_mesh(ensemble=4, data=2, world_size=8, rank=rank)
        batch = t_par.global_batch_tree(plan, tree)
        ens = t_par.global_ensemble_tree(plan, tree)
        for k in tree:
            np.testing.assert_array_equal(batch[k],
                                          _shard_of(jbatch[k], jplan, rank))
            np.testing.assert_array_equal(ens[k],
                                          _shard_of(jens[k], jplan, rank))


def test_shard_sequence_matches_jax_shards():
    """(B, T, C) leaves split on T, (B, H, T, D) on T and, with a head
    axis, on H; labels whole; as JAX's ``shard_sequence`` places them."""
    from multimodal_eeg_fmri_tpu.ops.ring_attention import (
        shard_sequence as j_shard,
    )

    r = np.random.default_rng(2)
    x4 = r.standard_normal((2, 4, 16, 3)).astype(np.float32)
    x3 = r.standard_normal((2, 16, 3)).astype(np.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                  ("seq", "model"))
    j4 = j_shard(jnp.asarray(x4), jmesh, axis="seq", head_axis="model")
    j3 = jax.device_put(jnp.asarray(x3),
                        NamedSharding(jmesh, P(None, "seq", None)))
    for rank in range(8):
        mesh = t_par.Mesh(np.arange(8).reshape(4, 2), ("seq", "model"),
                          rank=rank)
        got = t_par.shard_sequence({"a": x4, "b": x3, "label": x3[:, 0, 0]},
                                   mesh, "seq", "model")
        np.testing.assert_array_equal(got["a"], _shard_of(j4, jmesh, rank))
        np.testing.assert_array_equal(got["b"], _shard_of(j3, jmesh, rank))
        assert got["label"] is not None and got["label"].shape == (2,)
    with pytest.raises(ValueError, match="not divisible"):
        t_par.shard_sequence(x3[:, :15], mesh, "seq")


def test_tree_helpers_match_jax():
    from multimodal_eeg_fmri_tpu.models import long_context as j_lc
    from multimodal_eeg_fmri_tpu_torch import load_flax_variables
    from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier

    fmod = j_lc.LongContextClassifier(hidden_dim=16, num_layers=1,
                                      num_heads=2)
    variables = jax.jit(fmod.init)(jax.random.key(0),
                                   erp=jnp.zeros((1, 8, 18)))
    model = load_flax_variables(
        LongContextClassifier(hidden_dim=16, num_layers=1, num_heads=2,
                              device="cpu"), variables["params"])
    n = j_tree.count_parameters(variables["params"])
    size = j_tree.tree_size_bytes(variables["params"])
    numpy_tree = jax.tree.map(np.asarray, variables["params"])
    for tree in (model, model.state_dict(), numpy_tree):
        assert t_tree.count_parameters(tree) == n
        assert t_tree.tree_size_bytes(tree) == size
    mixed = {"x": np.ones((2, 3), np.float32), "i": np.arange(4),
             "t": [torch.ones(2), torch.arange(3)]}
    cast = t_tree.cast_floating(mixed)
    want = j_tree.cast_floating({"x": jnp.ones((2, 3)),
                                 "i": jnp.arange(4)})
    assert cast["x"].dtype == torch.bfloat16 and want["x"].dtype == jnp.bfloat16
    # integer leaves pass through in both (JAX's arange is int32, x64 off)
    assert cast["i"].dtype == mixed["i"].dtype
    assert want["i"].dtype == jnp.arange(4).dtype
    assert cast["t"][0].dtype == torch.bfloat16
    assert cast["t"][1].dtype == torch.int64
    assert t_tree.tree_size_bytes(cast) == 2 * 6 + 8 * 4 + 2 * 2 + 8 * 3
    half = t_tree.cast_floating(model)
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
    assert t_tree.tree_size_bytes(half) == size // 2


def test_unported_parts_name_their_queue_item():
    """Queue A items 7a-7d and 8 are ported: the package exports the JAX
    package's ``__all__`` and ``ensemble_vmap`` (``parallel/mesh.py``, as
    the JAX package's), no message of the port names item 7c, 7d or 8 any
    more, and a seed sweep whose seeds do not divide the ensemble axis
    raises the JAX package's error, word for word."""
    from pathlib import Path

    from multimodal_eeg_fmri_tpu import parallel as j_par
    from multimodal_eeg_fmri_tpu_torch import TrainConfig
    from multimodal_eeg_fmri_tpu_torch.train import cv as t_cv

    from multimodal_eeg_fmri_tpu.parallel import mesh as j_mesh

    assert set(j_par.__all__) <= set(t_par.__all__)
    for name in t_par.__all__:
        assert hasattr(t_par, name), name
    assert "ensemble_vmap" in t_par.__all__
    assert (list(inspect.signature(t_par.ensemble_vmap).parameters)
            == list(inspect.signature(j_mesh.ensemble_vmap).parameters))
    root = Path(t_par.__file__).parents[1]
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert not any(f"item {i}" in text for i in ("7c", "7d", "8")), path
    plan = t_par.build_mesh(ensemble=2, world_size=2, rank=0)
    with pytest.raises(ValueError) as err:
        t_cv.run_seed_sweep(None, TrainConfig(),
                            {"label": np.zeros(2, np.int64)},
                            {}, 3, mesh_plan=plan)
    assert str(err.value) == "the ensemble axis (2) must divide n_seeds=3"