"""Unit tests for ops/linalg.py — the latency-tuned replacements for the
stock batched Cholesky/triangular-solve lowerings (exactness is the whole
contract: same arithmetic, reordered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesfmmm_tpu.ops.linalg import (
    blocked_cholesky,
    blocked_tri_solves,
    mvn_from_precision_fused,
    precision_draw_pair,
    small_chol,
    small_chol_logdet,
    small_solve_lower,
    small_solve_upper_t,
)


def _spd(key, batch, D, diag=50.0):
    A = jax.random.normal(key, batch + (D, D))
    return A @ jnp.swapaxes(A, -1, -2) + diag * jnp.eye(D)


def _ref_solves(A, b, z):
    L = jnp.linalg.cholesky(A)
    w = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    mean = jax.scipy.linalg.solve_triangular(L.mT, w, lower=False)[..., 0]
    noise = jax.scipy.linalg.solve_triangular(
        L.mT, z[..., None], lower=False)[..., 0]
    return mean, noise


@pytest.mark.parametrize("D", [48, 96])
def test_blocked_tri_solves_matches_stock(D):
    key = jax.random.PRNGKey(0)
    A = _spd(key, (7,), D)
    b = jax.random.normal(jax.random.fold_in(key, 1), (7, D))
    z = jax.random.normal(jax.random.fold_in(key, 2), (7, D))
    L = jnp.linalg.cholesky(A)
    mean, noise = jax.jit(blocked_tri_solves)(L, b, z)
    mean_ref, noise_ref = _ref_solves(A, b, z)
    np.testing.assert_allclose(mean, mean_ref, atol=5e-5)
    np.testing.assert_allclose(noise, noise_ref, atol=5e-4)


@pytest.mark.parametrize("D", [64, 96])
def test_blocked_cholesky_matches_stock(D):
    A = _spd(jax.random.PRNGKey(3), (5,), D)
    L_ref = jnp.linalg.cholesky(A)
    L = jax.jit(blocked_cholesky)(A)
    np.testing.assert_allclose(L, L_ref, atol=1e-4)


@pytest.mark.parametrize("M", [2, 4, 8])
def test_small_chol_and_solves(M):
    key = jax.random.PRNGKey(1)
    A = _spd(key, (6, 11), M, diag=10.0)
    b = jax.random.normal(jax.random.fold_in(key, 1), (6, 11, M))
    L_ref = jnp.linalg.cholesky(A)
    L = jax.jit(small_chol)(A)
    np.testing.assert_allclose(L, L_ref, atol=1e-5)
    x = jax.jit(small_solve_lower)(L, b)
    x_ref = jax.scipy.linalg.solve_triangular(
        L_ref, b[..., None], lower=True)[..., 0]
    np.testing.assert_allclose(x, x_ref, atol=1e-5)
    y = jax.jit(small_solve_upper_t)(L, b)
    y_ref = jax.scipy.linalg.solve_triangular(
        L_ref.mT, b[..., None], lower=False)[..., 0]
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    ld = small_chol_logdet(L)
    _, ld_ref = jnp.linalg.slogdet(A)
    np.testing.assert_allclose(ld, ld_ref, rtol=1e-5)


def test_precision_draw_pair_vmapped_matches_reference():
    """The chain-vmapped draw must equal the stock batched factor+solve."""
    key = jax.random.PRNGKey(2)
    A = _spd(key, (9,), 48)
    b = jax.random.normal(jax.random.fold_in(key, 1), (9, 48))
    z = jax.random.normal(jax.random.fold_in(key, 2), (9, 48))
    mean, noise = jax.jit(jax.vmap(precision_draw_pair))(A, b, z)
    mean_ref, noise_ref = _ref_solves(A, b, z)
    np.testing.assert_allclose(mean, mean_ref, atol=5e-5)
    np.testing.assert_allclose(noise, noise_ref, atol=5e-4)


def test_precision_draw_pair_large_d_blocked_path():
    """D=256 (config 4's joint xi dimension) through the blocked
    substitution — value-equivalent to the stock pipeline."""
    key = jax.random.PRNGKey(6)
    A = _spd(key, (3,), 256, diag=40.0)
    b = jax.random.normal(jax.random.fold_in(key, 1), (3, 256))
    z = jax.random.normal(jax.random.fold_in(key, 2), (3, 256))
    mean, noise = jax.jit(jax.vmap(precision_draw_pair))(A, b, z)
    mean_ref, noise_ref = _ref_solves(A, b, z)
    np.testing.assert_allclose(mean, mean_ref, atol=5e-5)
    np.testing.assert_allclose(noise, noise_ref, atol=5e-4)


def test_mvn_from_precision_fused_moments():
    """Draws from mvn_from_precision_fused must have the conjugate mean and
    covariance (moment test, vmapped over draws)."""
    key = jax.random.PRNGKey(5)
    D = 16
    A = _spd(key, (), D, diag=20.0)
    b = jax.random.normal(jax.random.fold_in(key, 1), (D,))
    n = 4000
    keys = jax.random.split(jax.random.fold_in(key, 2), n)
    samp, mean = jax.jit(jax.vmap(
        lambda k: mvn_from_precision_fused(k, A, b)))(keys)
    target_mean = jnp.linalg.solve(A, b)
    np.testing.assert_allclose(mean[0], target_mean, atol=1e-4)
    emp_mean = jnp.mean(samp, axis=0)
    emp_cov = jnp.cov(np.asarray(samp).T)
    np.testing.assert_allclose(emp_mean, target_mean, atol=0.05)
    np.testing.assert_allclose(emp_cov, jnp.linalg.inv(A),
                               atol=0.05)
