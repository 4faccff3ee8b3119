"""``parallel.ensemble_vmap`` against the JAX package's, in a spawned world
of 2 gloo ranks (rank body ``test_torch_port_workers.ensemble_vmap_cases``,
no JAX in the workers).

Four fold-stacked weight sets of a narrow ``TriModalFusionNetV4`` (hidden
32, one layer, two heads, T = 32, every attention layer on the flash
route), seeded flax variables carried across by ``load_flax_variables``:
the eval-mode logits mapped over the fold axis with the inputs shared
(``in_axes=(0, None)``) on an (ensemble 2) mesh, on a (data 2) mesh (its
ranks repeat every fold, as inputs replicate across ``data`` in the JAX
package), and with every argument mapped. Every rank returns the whole
fold axis, bit for bit the port's unsharded ``torch.func.vmap`` of the same
function, and within 1e-5 of ``jax.vmap`` of the flax model's logits, which
the JAX package's ``ensemble_vmap`` equals (``parallel/mesh.py:124-127``).
A plan with no process group runs in one process; ``in_axes`` other than 0
or None raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from multimodal_eeg_fmri_tpu_torch.parallel import (
    build_mesh,
    ensemble_vmap,
    spawn_local_world,
)
from test_torch_port_deploy import TRI, JTri, eeg_inputs, port_model, seeded

import test_torch_port_workers as workers

# one torch thread per pytest-xdist worker: see test_torch_port_train.py
torch.set_num_threads(1)

K, N = 4, 5
ATOL = 1e-5


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@pytest.fixture(scope="module")
def members():
    variables = [seeded(10 + i) for i in range(K)]
    data = eeg_inputs(N, seed=3)
    data_k = [eeg_inputs(N, seed=20 + i) for i in range(K)]
    stacked = _stack([port_model(v).state_dict() for v in variables])
    as_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    return dict(variables=variables, stacked=stacked, data=as_t(data),
                data_k=_stack([as_t(d) for d in data_k]),
                np_data=data, np_data_k=data_k)


def _unsharded(m, in_dims, inputs):
    model = port_model().eval()

    def member(tensors, x):
        return functional_call(model, tensors, (), x).logits

    with torch.no_grad():
        return torch.func.vmap(member, in_dims=in_dims)(m["stacked"], inputs)


def _jax(m, mapped):
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *m["variables"])
    fn = lambda v, x: JTri(**TRI).apply(v, **x, train=False).logits  # noqa
    if mapped:
        x = jax.tree.map(lambda *a: jnp.stack(a), *m["np_data_k"])
        return np.asarray(jax.vmap(fn)(stacked, x))
    x = jax.tree.map(jnp.asarray, m["np_data"])
    return np.asarray(jax.vmap(fn, in_axes=(0, None))(stacked, x))


def test_ensemble_vmap_in_a_world_of_two(members):
    m = members
    ranks = spawn_local_world(workers.ensemble_vmap_cases, 2, TRI,
                              m["stacked"], m["data"], m["data_k"])
    assert not any(jax_loaded for _, jax_loaded in ranks)
    shared = _unsharded(m, (0, None), m["data"])
    mapped = _unsharded(m, 0, m["data_k"])
    assert shared.shape == mapped.shape == (K, N, 2)
    for out, _ in ranks:
        assert torch.equal(out["ensemble"], shared)
        assert torch.equal(out["data"], shared)
        assert torch.equal(out["mapped"], mapped)
    np.testing.assert_allclose(shared.numpy(), _jax(m, False), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(mapped.numpy(), _jax(m, True), atol=ATOL,
                               rtol=0)


def test_ensemble_vmap_without_a_process_group(members):
    m = members
    model = port_model().eval()

    def member(tensors, x):
        return functional_call(model, tensors, (), x).logits

    plan = build_mesh(world_size=1)
    with torch.no_grad():
        got = ensemble_vmap(member, plan, in_axes=(0, None))(m["stacked"],
                                                             m["data"])
    assert torch.equal(got, _unsharded(m, (0, None), m["data"]))
    for bad in ((1, None), (0,)):
        with pytest.raises(ValueError, match="in_axes"):
            ensemble_vmap(member, plan, in_axes=bad)(m["stacked"], m["data"])
