"""Whole-model log-joint on unconstrained parameters (gradient-based path).

The gradient-based alternative to per-parameter Gibbs (SURVEY.md §7 architecture
stance): one vectorized log-joint over unconstrained parameters, sampled by
HMC with chain-parallel vmap.  Transforms:

  * Z rows, pi       — additive-log-ratio softmax (last coordinate pinned),
                       with the Dirichlet prior density + ALR Jacobian
  * alpha3, sigma2, tau, gamma, delta, A (+ xi towers) — log transform
  * Phi, xi          — NON-CENTERED: Phi = raw / sqrt(tilde_tau * gamma);
                       raw ~ N(0,1).  This cures the MGP funnel geometry
                       (SURVEY.md §7 "hard parts": delta cumulative products,
                       UpdateDelta.h:33-41) that defeats centered HMC.

Priors follow the reference exactly (citations inline): the functional
smoothness prior nu_k ~ N(0, (tau_k * pen)^-1) uses the penalty's rank for
its normalizing power since RW(1)/graph penalties are singular
(rank P-1; BFMMM.h:1402-1412, BSplines.h:70-120).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from bayesfmmm_tpu.models.state import GibbsState
from bayesfmmm_tpu.ops.distributions import log_multi_beta
from bayesfmmm_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class UncState:
    """Unconstrained parameter pytree (one chain)."""
    z_raw: jax.Array       # (N, K-1)
    pi_raw: jax.Array      # (K-1,)
    log_alpha3: jax.Array  # ()
    nu: jax.Array          # (K, P)
    log_tau: jax.Array     # (K,)
    log_sigma2: jax.Array  # ()
    chi: jax.Array         # (N, M)
    Phi_raw: jax.Array     # (K, P, M) non-centered
    log_gamma: jax.Array   # (K, P, M)
    log_delta: jax.Array   # (K, M)
    log_A: jax.Array       # (K, 2)
    eta: jax.Array         # (K, P, D)
    log_tau_eta: jax.Array  # (K, D)
    xi_raw: jax.Array      # (K, P, D, M) non-centered
    log_gamma_xi: jax.Array  # (K, P, D, M)
    log_delta_xi: jax.Array  # (K, M, D)
    log_A_xi: jax.Array      # (K, 2, D)


def _alr_forward(raw):
    """softmax([raw, 0]) along the last axis; returns (simplex, log|J|)."""
    z = jnp.concatenate([raw, jnp.zeros(raw.shape[:-1] + (1,), raw.dtype)],
                        axis=-1)
    logp = z - jax.scipy.special.logsumexp(z, axis=-1, keepdims=True)
    # Jacobian of ALR^-1: |J| = prod_k simplex_k
    return jnp.exp(logp), jnp.sum(logp, axis=-1)


def _alr_inverse(simplex, eps=1e-8):
    s = jnp.clip(simplex, eps, 1.0)
    return jnp.log(s[..., :-1]) - jnp.log(s[..., -1:])


def to_state(unc: UncState) -> GibbsState:
    """Map unconstrained coordinates to the natural parameterization."""
    Z, _ = _alr_forward(unc.z_raw)
    pi, _ = _alr_forward(unc.pi_raw)
    gamma = jnp.exp(unc.log_gamma)
    delta = jnp.exp(unc.log_delta)
    tilde_tau = jnp.cumprod(delta, axis=1)                     # (K, M)
    Phi = unc.Phi_raw / jnp.sqrt(gamma * tilde_tau[:, None, :])
    gamma_xi = jnp.exp(unc.log_gamma_xi)
    delta_xi = jnp.exp(unc.log_delta_xi)
    if unc.xi_raw.shape[2] > 0:
        tt_xi = jnp.cumprod(delta_xi, axis=1)                  # (K, M, D)
        scale_xi = jnp.sqrt(gamma_xi * tt_xi.transpose(0, 2, 1)[:, None])
        xi = unc.xi_raw / scale_xi
    else:
        xi = unc.xi_raw
    return GibbsState(
        Z=Z, pi=pi, alpha3=jnp.exp(unc.log_alpha3), nu=unc.nu,
        tau=jnp.exp(unc.log_tau), sigma2=jnp.exp(unc.log_sigma2),
        chi=unc.chi, Phi=Phi, gamma=gamma, delta=delta,
        A=jnp.exp(unc.log_A), eta=unc.eta,
        tau_eta=jnp.exp(unc.log_tau_eta), xi=xi, gamma_xi=gamma_xi,
        delta_xi=delta_xi, A_xi=jnp.exp(unc.log_A_xi))


def from_state(state: GibbsState) -> UncState:
    """Inverse map (for warm-starting HMC from a Gibbs state)."""
    gamma = state.gamma
    tilde_tau = jnp.cumprod(state.delta, axis=1)
    Phi_raw = state.Phi * jnp.sqrt(gamma * tilde_tau[:, None, :])
    if state.xi.shape[2] > 0:
        tt_xi = jnp.cumprod(state.delta_xi, axis=1)
        scale_xi = jnp.sqrt(state.gamma_xi
                            * tt_xi.transpose(0, 2, 1)[:, None])
        xi_raw = state.xi * scale_xi
    else:
        xi_raw = state.xi
    return UncState(
        z_raw=_alr_inverse(state.Z), pi_raw=_alr_inverse(state.pi),
        log_alpha3=jnp.log(state.alpha3), nu=state.nu,
        log_tau=jnp.log(state.tau), log_sigma2=jnp.log(state.sigma2),
        chi=state.chi, Phi_raw=Phi_raw, log_gamma=jnp.log(state.gamma),
        log_delta=jnp.log(state.delta), log_A=jnp.log(state.A),
        eta=state.eta, log_tau_eta=jnp.log(state.tau_eta), xi_raw=xi_raw,
        log_gamma_xi=jnp.log(state.gamma_xi),
        log_delta_xi=jnp.log(state.delta_xi),
        log_A_xi=jnp.log(state.A_xi))


def init_unc(key, cfg, data, dtype=jnp.float32) -> UncState:
    N, P, D, K, M = data.N, data.P, data.D, cfg.K, cfg.M
    ks = jax.random.split(key, 5)
    return UncState(
        z_raw=0.1 * jax.random.normal(ks[0], (N, K - 1), dtype),
        pi_raw=jnp.zeros((K - 1,), dtype),
        log_alpha3=jnp.asarray(0.0, dtype),
        nu=jax.random.normal(ks[1], (K, P), dtype),
        log_tau=jnp.zeros((K,), dtype),
        log_sigma2=jnp.asarray(0.0, dtype),
        chi=jax.random.normal(ks[2], (N, M), dtype),
        Phi_raw=jax.random.normal(ks[3], (K, P, M), dtype),
        log_gamma=jnp.zeros((K, P, M), dtype),
        log_delta=jnp.zeros((K, M), dtype),
        log_A=jnp.zeros((K, 2), dtype),
        eta=jnp.zeros((K, P, D), dtype),
        log_tau_eta=jnp.zeros((K, D), dtype),
        xi_raw=jnp.zeros((K, P, D, M), dtype),
        log_gamma_xi=jnp.zeros((K, P, D, M), dtype),
        log_delta_xi=jnp.zeros((K, M, D), dtype),
        log_A_xi=jnp.zeros((K, 2, D), dtype))


def make_log_joint(data, hp, c, pen_rank=None, temperature=1.0):
    """Returns log_joint(unc) -> scalar.

    ``temperature`` multiplies only the data likelihood (the reference's
    tempering semantics, e.g. UpdateNu.h:134-136).
    """
    if pen_rank is None:
        pen_rank = int(np.linalg.matrix_rank(np.asarray(data.pen)))
    n_obs = data.n_obs_total

    def log_joint(unc: UncState):
        from bayesfmmm_tpu.ops.mean import effective_coeffs, rss_from_coeffs
        state = to_state(unc)
        K = state.pi.shape[0]
        D = data.D

        # --- likelihood (CalculateLikelihood.h:19-44), Gram-space RSS ---
        rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
        ll = -0.5 * n_obs * (jnp.log(2 * jnp.pi) + unc.log_sigma2) \
            - 0.5 * rss / state.sigma2

        lp = temperature * ll

        # --- Z | pi, alpha3 ~ Dir(alpha3 * pi) + ALR jacobian ---
        _, jac_z = _alr_forward(unc.z_raw)
        a3pi = state.alpha3 * state.pi
        lp += jnp.sum((a3pi - 1.0) * jnp.log(state.Z)) \
            - data.N * log_multi_beta(a3pi) + jnp.sum(jac_z)

        # --- pi ~ Dir(c) ---
        _, jac_pi = _alr_forward(unc.pi_raw)
        lp += jnp.sum((c - 1.0) * jnp.log(state.pi)) + jac_pi

        # --- alpha3 ~ Exp(b) (UpdateAlpha3.h:16) ---
        lp += -hp.b * state.alpha3 + unc.log_alpha3

        # --- nu_k | tau_k ~ N(0, (tau_k pen)^-1) (UpdateNu.h:66) ---
        quad = jnp.einsum("kp,pq,kq->k", state.nu, data.pen, state.nu,
                          precision="highest")
        lp += jnp.sum(0.5 * pen_rank * unc.log_tau - 0.5 * state.tau * quad)

        # --- tau ~ Gamma(alpha_nu, beta_nu) (UpdateTau.h:18-36) ---
        lp += jnp.sum(hp.alpha_nu * unc.log_tau - hp.beta_nu * state.tau)

        # --- sigma2 ~ IG(alpha_0, beta_0) (UpdateSigma.h:53) ---
        lp += -hp.alpha_0 * unc.log_sigma2 - hp.beta_0 / state.sigma2

        # --- chi ~ N(0, 1) (UpdateChi.h:56-58) ---
        lp += -0.5 * jnp.sum(unc.chi**2)

        # --- Phi (non-centered): raw ~ N(0,1) ---
        lp += -0.5 * jnp.sum(unc.Phi_raw**2)

        # --- gamma ~ Gamma(nu1/2, nu1/2) (UpdateGamma.h:29) ---
        lp += jnp.sum(0.5 * hp.nu_1 * unc.log_gamma
                      - 0.5 * hp.nu_1 * state.gamma)

        # --- MGP delta: delta_1 ~ Ga(a1, 1), delta_j ~ Ga(a2, 1)
        #     (UpdateDelta.h:29,44 prior structure) ---
        a1 = state.A[:, 0]
        a2 = state.A[:, 1]
        lp += jnp.sum(a1 * unc.log_delta[:, 0] - state.delta[:, 0]
                      - gammaln(a1))
        if state.delta.shape[1] > 1:
            lp += jnp.sum(a2[:, None] * unc.log_delta[:, 1:]
                          - state.delta[:, 1:]
                          - gammaln(a2)[:, None])

        # --- A ~ Gamma(alpha_l, beta_l) (UpdateA.h:17-44) ---
        lp += jnp.sum(hp.alpha1l * unc.log_A[:, 0]
                      - hp.beta1l * state.A[:, 0])
        lp += jnp.sum(hp.alpha2l * unc.log_A[:, 1]
                      - hp.beta2l * state.A[:, 1])

        if D > 0:
            # eta | tau_eta (UpdateEta.h:84)
            quad_e = jnp.einsum("kpd,pq,kqd->kd", state.eta, data.pen,
                                state.eta, precision="highest")
            lp += jnp.sum(0.5 * pen_rank * unc.log_tau_eta
                          - 0.5 * state.tau_eta * quad_e)
            lp += jnp.sum(hp.alpha_eta * unc.log_tau_eta
                          - hp.beta_eta * state.tau_eta)
            # xi tower (non-centered) mirrors Phi's
            lp += -0.5 * jnp.sum(unc.xi_raw**2)
            lp += jnp.sum(0.5 * hp.nu_1 * unc.log_gamma_xi
                          - 0.5 * hp.nu_1 * state.gamma_xi)
            a1x = state.A_xi[:, 0, :]
            a2x = state.A_xi[:, 1, :]
            lp += jnp.sum(a1x * unc.log_delta_xi[:, 0, :]
                          - state.delta_xi[:, 0, :] - gammaln(a1x))
            if state.delta_xi.shape[1] > 1:
                lp += jnp.sum(a2x[:, None, :] * unc.log_delta_xi[:, 1:, :]
                              - state.delta_xi[:, 1:, :]
                              - gammaln(a2x)[:, None, :])
            lp += jnp.sum(hp.alpha1l * unc.log_A_xi[:, 0, :]
                          - hp.beta1l * state.A_xi[:, 0, :])
            lp += jnp.sum(hp.alpha2l * unc.log_A_xi[:, 1, :]
                          - hp.beta2l * state.A_xi[:, 1, :])
        return lp

    return log_joint
