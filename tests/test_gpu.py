"""Tests that need an NVIDIA GPU (marker ``gpu``).

They skip on other backends and run on the card, in the same process as
the rest of the smoke check, through ``python chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return dev


def test_highest_precision_contraction_is_float32(gpu):
    """precision="highest" keeps float32 (TF32 keeps ~3 digits) for the
    sweep's contraction shapes: (N, K) @ (K,), (N, M) @ (M, M) and the
    Gram einsum."""
    rng = np.random.default_rng(0)
    Z = rng.uniform(size=(100, 3))
    e = rng.normal(size=(3,))
    chi = rng.normal(size=(100, 4))
    R = rng.normal(size=(4, 4))
    W = rng.normal(size=(12, 100))
    G = rng.normal(size=(100, 8, 8))
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    got = [jnp.dot(f32(Z), f32(e), precision="highest"),
           jnp.dot(f32(chi), f32(R), precision="highest"),
           jnp.einsum("an,bn,npq->apbq", f32(W), f32(W), f32(G),
                      precision="highest")]
    want = [Z @ e, chi @ R, np.einsum("an,bn,npq->apbq", W, W, G)]
    for g, w in zip(got, want):
        assert g.devices() == {gpu}
        err = np.max(np.abs(np.asarray(g, np.float64) - w)) / np.max(np.abs(w))
        assert err < 1e-5, err


def test_joint_draw_moments_on_gpu(gpu):
    """mvn_from_precision_fused draws on the card have the conjugate mean
    and covariance."""
    from bayesfmmm_tpu.ops.linalg import mvn_from_precision_fused
    key = jax.random.PRNGKey(5)
    D = 16
    X = jax.random.normal(key, (D, D))
    A = X @ X.T + 20.0 * jnp.eye(D)
    b = jax.random.normal(jax.random.fold_in(key, 1), (D,))
    keys = jax.random.split(jax.random.fold_in(key, 2), 20000)
    samp, mean = jax.jit(jax.vmap(
        lambda k: mvn_from_precision_fused(k, A, b)))(keys)
    A64 = np.asarray(A, np.float64)
    target = np.linalg.solve(A64, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(mean[0]), target, atol=1e-5)
    s = np.asarray(samp, np.float64)
    np.testing.assert_allclose(s.mean(0), target, atol=0.02)
    np.testing.assert_allclose(np.cov(s.T), np.linalg.inv(A64), atol=0.02)


def test_checkpoint_round_trip_from_gpu(gpu, tmp_path):
    """A chain ensemble on the card survives save/load bit for bit."""
    from bayesfmmm_tpu.config import ModelConfig
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.utils.simulate import simulate_functional
    data, _ = simulate_functional(seed=3, N=20, K=2, P=6, M=2,
                                  n_time=(20, 20))
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    states = jax.jit(jax.vmap(lambda k: init_state(
        k, ModelConfig(K=2, P=6, M=2), data)))(keys)
    save_checkpoint(str(tmp_path / "ens.npz"), states, keys, iteration=3)
    back, kb, it = load_checkpoint(str(tmp_path / "ens.npz"))
    assert it == 3
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(kb)),
                                  np.asarray(keys))
    for a, b in zip(jax.tree.leaves(states), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
