"""Vectorized mean-structure assembly for the mixed membership likelihood.

The model mean (README.md:14):

    E[y_i(t_l)] = sum_k Z_ik [ B_il·(nu_k + eta_k x_i)
                               + sum_m chi_im B_il·(Phi_km + xi_km x_i) ]

The reference recomputes scalar dot products of this expression inside
quadruple loops in every updater (e.g. UpdateNu.h:42-63, UpdatePhi.h:44-71).

Key identity: the whole bracket collapses to ONE P-vector per
observation,

    w_n = sum_k Z_nk [ nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n ],

so  mu = batched-matvec(B, w)  at O(N·K·P·(M + D + M·D)) + O(N·L·P) cost —
the naive design-product materialization B·Phi of shape (N, L, K, M) costs
O(N·L·P·K·M) FLOPs and HBM traffic and is never needed.  When D == 0 the
eta/xi einsums contract over an empty axis and vanish for free.

Second identity (Gram space): every Gibbs conditional only needs
residuals through B_n' r_n and ||r_n||^2, and with the precomputed
sufficient statistics u_n = B_n'y_n, G_n = B_n'B_n, yy_n = ||y_n||^2
(models/state.py) these are

    B_n' r_n   = u_n − G_n w_n,

so the sweep maintains only the P-vector w_n per observation and NO (N, L)
tensor appears in the blocked hot loops — an L/P-fold cut in HBM traffic
(the reference recomputes length-n_i residuals in every scalar loop,
UpdateNu.h:42-63).  The *squared* residual norm is the exception: the Gram
identity yy − 2u·w + w'Gw cancels catastrophically in f32, so RSS-type
quantities (sigma2 draws, loglik, MH quadratics) materialize the length-L
residual once per call (rss_from_coeffs / rss_rows_from_coeffs) — linear
terms stay in Gram space, squared norms go through the residual.
"""

from __future__ import annotations

import jax.numpy as jnp

from bayesfmmm_tpu.utils.pytree import pytree_dataclass

_EINSUM_KW = dict(precision="highest")


@pytree_dataclass
class SweepCache:
    """Running effective mean coefficients, maintained through a sweep.

    w[n] is the P-vector such that the model mean is mu_n = B_n w[n]; each
    blocked updater subtracts its own rank-1 contribution, redraws, and adds
    it back — all in P-dimensional Gram space."""
    w: jnp.ndarray      # (N, P)


def effective_coeffs(state, X):
    """w[n, p] — the per-observation basis coefficients of the model mean."""
    w = jnp.einsum("nk,kp->np", state.Z, state.nu, **_EINSUM_KW)
    w = w + jnp.einsum("nk,kpm,nm->np", state.Z, state.Phi, state.chi,
                       **_EINSUM_KW)
    if X.shape[1] > 0:
        w = w + jnp.einsum("nk,kpd,nd->np", state.Z, state.eta, X,
                           **_EINSUM_KW)
        w = w + jnp.einsum("nk,kpdm,nd,nm->np", state.Z, state.xi, X,
                           state.chi, **_EINSUM_KW)
    return w


def compute_mu(data, state):
    w = effective_coeffs(state, data.X)
    if getattr(data, "identity_basis", False):
        return w                               # B = I, L = P
    return jnp.einsum("nlp,np->nl", data.B, w, **_EINSUM_KW)


def build_cache(data, state) -> SweepCache:
    return SweepCache(w=effective_coeffs(state, data.X))


def rss_from_coeffs(data, w):
    """sum_n ||y_n - B_n w_n||^2, evaluated in residual space.

    The Gram identity yy - 2 u.w + w'Gw cancels catastrophically in f32
    (error ~ eps*||y_n||^2, can go negative on high-SNR data), corrupting
    sigma2 draws, loglik traces, SMC weights and PT/TT acceptance; the
    residual form is exact to rounding of one matvec.  B rows and y are
    pre-zeroed at padded points so no mask is needed.  Cost O(N*L*P) once
    per call — outside the blocked kernels, which stay in Gram space."""
    if getattr(data, "identity_basis", False):
        r = data.y - w
        return jnp.sum(r * r)
    r = data.y - jnp.einsum("nlp,np->nl", data.B, w, **_EINSUM_KW)
    return jnp.sum(r * r)


def rss_rows_from_coeffs(data, w):
    """Per-observation ||y_n - B_n w_n||^2 (residual space; see
    rss_from_coeffs for why not the Gram identity)."""
    if getattr(data, "identity_basis", False):
        r = data.y - w
    else:
        r = data.y - jnp.einsum("nlp,np->nl", data.B, w, **_EINSUM_KW)
    return jnp.sum(r * r, axis=1)


def feature_offsets(state, X):
    """T[n, k, p] = nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n — the
    per-feature mean coefficients seen by observation n (Z-independent).
    Used by the Z updater: mu_n(Z-row) = B_n (sum_k z_k T_nk)."""
    T = state.nu[None] + jnp.einsum("kpm,nm->nkp", state.Phi, state.chi,
                                    **_EINSUM_KW)
    if X.shape[1] > 0:
        T = T + jnp.einsum("kpd,nd->nkp", state.eta, X, **_EINSUM_KW)
        T = T + jnp.einsum("kpdm,nd,nm->nkp", state.xi, X, state.chi,
                           **_EINSUM_KW)
    return T


def eigen_directions(state, X):
    """U[n, p, m] = sum_k Z_nk (Phi_k + xi_k x_n) — the effective
    eigen-directions for observation n.  Used by the chi updater
    (F[n, l, m] = B_n U_n)."""
    U = jnp.einsum("nk,kpm->npm", state.Z, state.Phi, **_EINSUM_KW)
    if X.shape[1] > 0:
        U = U + jnp.einsum("nk,kpdm,nd->npm", state.Z, state.xi, X,
                           **_EINSUM_KW)
    return U
