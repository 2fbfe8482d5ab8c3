"""The sampler's state/data containers as JAX pytrees (utils/pytree.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesfmmm_tpu.config import ModelConfig
from bayesfmmm_tpu.models.state import GibbsState, ModelData, init_state
from bayesfmmm_tpu.ops.mean import SweepCache
from bayesfmmm_tpu.utils.simulate import simulate_functional, \
    simulate_multivariate


def _state():
    data, _ = simulate_functional(seed=4, N=6, K=2, P=5, M=2,
                                  n_time=(8, 8))
    return data, init_state(jax.random.PRNGKey(0),
                            ModelConfig(K=2, P=5, M=2), data)


def test_flatten_unflatten_round_trip():
    data, state = _state()
    for obj in (data, state, SweepCache(w=jnp.ones((6, 5)))):
        leaves, treedef = jax.tree.flatten(obj)
        back = jax.tree.unflatten(treedef, leaves)
        assert type(back) is type(obj)
        for a, b in zip(jax.tree.leaves(obj), jax.tree.leaves(back)):
            assert a is b
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(state)]
    assert names == [f".{f.name}" for f in dataclasses.fields(GibbsState)]


def test_replace_returns_updated_copy_and_instances_are_frozen():
    _, state = _state()
    new = state.replace(sigma2=jnp.asarray(3.0))
    assert float(new.sigma2) == 3.0 and float(state.sigma2) == 1.0
    assert new.Z is state.Z
    with pytest.raises(dataclasses.FrozenInstanceError):
        state.sigma2 = jnp.asarray(2.0)


def test_static_fields_stay_out_of_leaves_under_jit_and_vmap():
    data, _ = simulate_multivariate(seed=2, N=10, K=2, P=3, M=1)
    leaves = jax.tree.leaves(data)
    assert len(leaves) == len(dataclasses.fields(ModelData)) - 2
    assert all(isinstance(x, jax.Array) for x in leaves)

    @jax.jit
    def f(d):
        # static fields are plain Python values while tracing
        assert d.identity_basis is True and d.family == "multivariate"
        return jnp.sum(d.y)

    np.testing.assert_allclose(f(data), np.sum(np.asarray(data.y)),
                               rtol=1e-6)
    batched = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), data)

    def g(d):
        assert d.family == "multivariate" and d.y.shape == data.y.shape
        return jnp.sum(d.y)

    np.testing.assert_allclose(jax.vmap(g)(batched),
                               np.array([1, 2]) * np.sum(np.asarray(data.y)),
                               rtol=1e-6)
    # a different static value is a different treedef (a new jit trace)
    other = data.replace(family="functional")
    assert jax.tree.structure(other) != jax.tree.structure(data)
