"""Sampling and density primitives for the Gibbs kernels.

Replacements for the reference's R-RNG-backed helpers
(Distributions.h, RcppDist truncnorm.h, arma::mvnrnd):

  * ``rdirichlet``      — gamma-normalize with the reference's floor-at-10
                          numerical guard (Distributions.h:22-44).
  * ``log_multi_beta``  — calc_lB (Distributions.h:51-60).
  * ``truncnorm_*``     — positive-half-line truncated normal proposal /
                          density used by the alpha_3 and A MH kernels.
  * ``mvn_from_precision`` — draw from N(P^{-1} b, P^{-1}) given a precision
                          matrix, via jittered Cholesky.  The reference uses
                          ``arma::pinv`` + symmetrization (UpdateNu.h:67-68)
                          to survive singular precisions; here a scaled
                          diagonal jitter achieves the same robustness with
                          O(P^3/3) triangular work and no SVD.

All functions are jit/vmap-safe and keyed by explicit PRNG keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammaln, ndtr

__all__ = [
    "rdirichlet", "dirichlet_logpdf_unnormalized", "log_multi_beta",
    "truncnorm_sample", "truncnorm_logpdf", "mvn_from_precision",
]


def rdirichlet(key, alpha):
    """Dirichlet draw with the reference's non-positive-alpha guard.

    Distributions.h:24-28 floors any alpha <= 0 at 10 before sampling, a
    numerical self-healing measure for degenerate MH proposals.
    """
    alpha = jnp.where(alpha <= 0, 10.0, alpha)
    g = jax.random.gamma(key, alpha)
    return g / jnp.sum(g, axis=-1, keepdims=True)


def log_multi_beta(alpha):
    """log B(alpha) = sum(lgamma(alpha)) - lgamma(sum(alpha)).

    Reference: calc_lB (Distributions.h:51-60).
    """
    return jnp.sum(gammaln(alpha), axis=-1) - gammaln(jnp.sum(alpha, axis=-1))


def dirichlet_logpdf_unnormalized(x, alpha):
    """sum((alpha-1) * log x) - log B(alpha).

    Matches Z_proposal_density / pi_proposal_density
    (UpdateMixedMembership.h:102-113, UpdatePi.h:60-71), including evaluating
    the *guarded* concentration when alpha came from rdirichlet proposals.
    """
    return jnp.sum((alpha - 1.0) * jnp.log(x), axis=-1) - log_multi_beta(alpha)


def truncnorm_sample(key, mean, sd, shape=()):
    """Draw from N(mean, sd^2) truncated to (0, inf)."""
    mean = jnp.asarray(mean)
    sd = jnp.asarray(sd)
    lower = -mean / sd
    z = jax.random.truncated_normal(
        key, lower, jnp.full_like(lower, jnp.inf),
        shape=jnp.broadcast_shapes(shape, lower.shape))
    return mean + sd * z


def truncnorm_logpdf(x, mean, sd):
    """log density of N(mean, sd^2) truncated to (0, inf) at x.

    Matches RcppDist d_truncnorm(x, mean, sd, 0, inf, log=1).
    """
    z = (x - mean) / sd
    log_phi = -0.5 * z * z - 0.5 * jnp.log(2.0 * jnp.pi) - jnp.log(sd)
    log_mass = jnp.log(ndtr(mean / sd))
    return log_phi - log_mass


def mvn_from_precision(key, prec, b, *, jitter=1e-6, dtype=None):
    """Sample from N(prec^{-1} b, prec^{-1}).

    The conjugate-Gibbs workhorse: every blocked update in the reference
    (UpdateNu.h:64-69, UpdatePhi.h:72-82, UpdateEta.h:82-87, UpdateXi.h:73-83)
    forms a precision matrix and draws arma::mvnrnd(B_1*b_1, B_1) after a
    pinv.  Here: jittered Cholesky ``prec + eps*scale*I = L L'``; the mean is
    two triangular solves and the noise is ``L^{-T} z``.

    Returns (sample, mean).
    """
    return mvn_from_chol(key, chol_precision(prec, jitter=jitter), b)


def chol_precision(prec, *, jitter=1e-6):
    """Jittered (batched) Cholesky of a precision matrix, prec + eps*scale*I.

    Factored out of mvn_from_precision so blocked-Gibbs kernels can batch
    the factorization of every block's precision upfront (ops/gibbs.py) and
    keep only triangular solves inside their sequential loops.  Small
    dimensions route through the entrywise-unrolled factorization — the
    stock lowering's while-loop iteration overhead dominates the sweep's
    latency chain (ops/linalg.py docstring)."""
    from bayesfmmm_tpu.ops import linalg
    P = prec.shape[-1]
    scale = jnp.trace(prec, axis1=-2, axis2=-1) / P + 1.0
    A = prec + (jitter * scale)[..., None, None] * jnp.eye(P, dtype=prec.dtype)
    return linalg.small_chol(A)     # falls back to stock above M=8


def mvn_from_chol(key, L, b):
    """Sample N(prec^{-1} b, prec^{-1}) given L = chol(prec); (sample, mean).

    Dimensions <= 8 use the unrolled substitutions (no while-loop latency,
    ops/linalg.py); larger ones the stock triangular solves."""
    from bayesfmmm_tpu.ops import linalg
    z = jax.random.normal(key, b.shape, dtype=b.dtype)
    if b.shape[-1] <= linalg.SMALL_MAX_DIM:
        w = linalg.small_solve_lower(L, b)
        mean = linalg.small_solve_upper_t(L, w)
        noise = linalg.small_solve_upper_t(L, z)
        return mean + noise, mean
    w = solve_triangular(L, b[..., None], lower=True)
    mean = solve_triangular(L.conj().mT, w, lower=False)[..., 0]
    noise = solve_triangular(L.conj().mT, z[..., None], lower=False)[..., 0]
    return mean + noise, mean
