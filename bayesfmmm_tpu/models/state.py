"""Model data and sampler state pytrees.

Redesign of the reference's per-parameter trace cubes
(BFMMM.h:1414-1449): instead of mutable Armadillo cubes indexed by iteration,
the sampler state is an immutable pytree holding the *current* draw of every
parameter; traces are produced functionally by ``lax.scan`` stacking.

Ragged functional data (``arma::field<arma::vec>`` in the reference) becomes
padded dense tensors + a mask — the static-shape representation.
All basis products are precomputed once on the host (the reference rebuilds
splines in every driver, BFMMM.h:1388-1400).

The three model families collapse into one code path:
  * functional:   B = B-spline design, penalty = RW(1)        (BFMMM.h:989)
  * hd:           B = tensor design,   penalty = GetP graph   (BFMMM.h:2892)
  * multivariate: B = identity,        penalty = I; the stored tau is the
    reciprocal of the internal precision scale (UpdateTau.h:47-63)
and covariate adjustment is D > 0 (eta/xi terms vanish identically at D=0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from bayesfmmm_tpu import basis as basis_mod
from bayesfmmm_tpu.config import ModelConfig
from bayesfmmm_tpu.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class ModelData:
    """Device-resident observation data + precomputed design constants.

    Shapes: N observations, L padded points/obs, P basis dim, D covariates.
    """
    y: jax.Array          # (N, L) padded observations
    mask: jax.Array       # (N, L) 1.0 where observed
    B: jax.Array          # (N, L, P) padded basis design (zeroed where masked)
    X: jax.Array          # (N, D) covariates (D may be 0)
    G: jax.Array          # (N, P, P) masked Gram matrices  B_i' W_i B_i
    pen: jax.Array        # (P, P) smoothness penalty (RW1 / graph / identity)
    u: jax.Array          # (N, P) basis-projected data  B_i' y_i
    yy: jax.Array         # (N,)   squared data norms  ||y_i||^2
    identity_basis: bool = static_field(False)
    # Model family carried with the data so every fitting path (Gibbs, HMC,
    # ADVI) builds the right ModelConfig without the caller restating it —
    # in particular the multivariate tau reciprocal at trace export
    # (UpdateTau.h:47-63) keys off this.
    family: str = static_field("functional")

    @property
    def N(self):
        return self.y.shape[0]

    @property
    def L(self):
        return self.y.shape[1]

    @property
    def P(self):
        return self.B.shape[2]

    @property
    def D(self):
        return self.X.shape[1]

    @property
    def n_obs_total(self):
        return jnp.sum(self.mask)


@pytree_dataclass
class GibbsState:
    """Current draw of every model parameter (one chain).

    Reference trace-shape table: README.md:33-51.  ``tau`` and ``tau_eta``
    here are always *precision scales* (prior precision = tau_k * pen); the
    multivariate family's stored inverse-Gamma tau (UpdateTau.h:58) is the
    reciprocal, applied at trace-export time.
    """
    Z: jax.Array          # (N, K) simplex rows — mixed membership
    pi: jax.Array         # (K,)   simplex — population allocation
    alpha3: jax.Array     # ()     Dirichlet concentration
    nu: jax.Array         # (K, P) feature means (basis coords)
    tau: jax.Array        # (K,)   mean smoothness precisions
    sigma2: jax.Array     # ()     residual variance
    chi: jax.Array        # (N, M) per-observation eigen scores
    Phi: jax.Array        # (K, P, M) pseudo-eigenfunction coords
    gamma: jax.Array      # (K, P, M) local t-scale precisions (MGP)
    delta: jax.Array      # (K, M) MGP column multipliers
    A: jax.Array          # (K, 2) MGP hyperparameters (a1, a2)
    # Covariate-adjusted terms (zero-size when D == 0)
    eta: jax.Array        # (K, P, D) covariate-adjusted mean coords
    tau_eta: jax.Array    # (K, D)   eta smoothness precisions
    xi: jax.Array         # (K, P, D, M) covariate-adjusted eigen coords
    gamma_xi: jax.Array   # (K, P, D, M)
    delta_xi: jax.Array   # (K, M, D)
    A_xi: jax.Array       # (K, 2, D)

    @property
    def K(self):
        return self.pi.shape[0]

    @property
    def M(self):
        return self.chi.shape[1]


def make_functional_data(y_list, t_list, *, basis_degree, internal_knots,
                         boundary_knots, X=None, dtype=jnp.float32) -> ModelData:
    """Pad ragged functional observations and precompute design constants.

    Replaces the reference's per-driver spline construction
    (BFMMM.h:1388-1412).  Each function i observed at t_list[i] (n_i points).
    """
    N = len(y_list)
    lengths = [len(np.asarray(t)) for t in t_list]
    L = max(lengths)
    P = len(np.asarray(internal_knots).ravel()) + int(basis_degree) + 1

    y = np.zeros((N, L))
    mask = np.zeros((N, L))
    B = np.zeros((N, L, P))
    for i, (yi, ti) in enumerate(zip(y_list, t_list)):
        ni = lengths[i]
        y[i, :ni] = np.asarray(yi).ravel()
        mask[i, :ni] = 1.0
        B[i, :ni] = basis_mod.bspline_basis(
            np.asarray(ti).ravel(), int(basis_degree),
            np.asarray(internal_knots), np.asarray(boundary_knots))
    pen = basis_mod.rw1_penalty(P)
    return _finalize_data(y, mask, B, X, pen, dtype, family="functional")


def make_hd_functional_data(y_list, t_list, *, basis_degrees, internal_knots_list,
                            boundary_knots, X=None, dtype=jnp.float32) -> ModelData:
    """Multi-dimensional-domain (surface/volume) functional data.

    Reference: tensor basis via TensorBSpline (BSplines.h:18-62) and graph
    penalty via GetP (BSplines.h:70-120).
    """
    N = len(y_list)
    lengths = [np.asarray(t).shape[0] for t in t_list]
    L = max(lengths)
    Bs = [basis_mod.tensor_bspline_basis(np.asarray(t), basis_degrees,
                                         internal_knots_list, boundary_knots)
          for t in t_list]
    P = Bs[0].shape[1]
    y = np.zeros((N, L))
    mask = np.zeros((N, L))
    B = np.zeros((N, L, P))
    for i, (yi, Bi) in enumerate(zip(y_list, Bs)):
        ni = lengths[i]
        y[i, :ni] = np.asarray(yi).ravel()
        mask[i, :ni] = 1.0
        B[i, :ni] = Bi
    pen = basis_mod.tensor_penalty(basis_degrees, internal_knots_list)
    return _finalize_data(y, mask, B, X, pen, dtype, family="hd")


def make_multivariate_data(y, X=None, dtype=jnp.float32) -> ModelData:
    """Multivariate observations: identity basis, identity penalty.

    Reference BMVMMM family (BFMMM.h:2183): no basis functions; the tau
    prior becomes inverse-Gamma (UpdateTau.h:47-63), which is exactly the
    functional Gamma update on the precision scale with penalty = I.
    """
    y = np.asarray(y, dtype=np.float64)
    N, P = y.shape
    mask = np.ones((N, P))
    B = np.broadcast_to(np.eye(P), (N, P, P)).copy()
    pen = np.eye(P)
    return _finalize_data(y, mask, B, X, pen, dtype, identity_basis=True,
                          family="multivariate")


def _finalize_data(y, mask, B, X, pen, dtype, identity_basis=False,
                   family="functional") -> ModelData:
    N = y.shape[0]
    if X is None:
        X = np.zeros((N, 0))
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    Bm = B * mask[:, :, None]
    G = np.einsum("nlp,nlq->npq", Bm, Bm)
    # Gram-space sufficient statistics (computed in f64 on the host): with
    # u_i = B_i'y_i and yy_i = ||y_i||^2, every residual contraction in the
    # Gibbs sweep collapses to P-dimensional algebra — no (N, L) tensor is
    # ever touched inside the hot loop (see ops/gibbs.py module docstring).
    ym = y * mask
    u = np.einsum("nlp,nl->np", Bm, ym)
    yy = np.einsum("nl,nl->n", ym, ym)
    return ModelData(
        y=jnp.asarray(y, dtype=dtype),
        mask=jnp.asarray(mask, dtype=dtype),
        B=jnp.asarray(Bm, dtype=dtype),
        X=jnp.asarray(X, dtype=dtype),
        G=jnp.asarray(G, dtype=dtype),
        pen=jnp.asarray(pen, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
        yy=jnp.asarray(yy, dtype=dtype),
        identity_basis=identity_basis,
        family=family,
    )


def init_state(key, cfg: ModelConfig, data: ModelData, c=None,
               dtype=jnp.float32) -> GibbsState:
    """Random initial state matching the reference driver's init distribution.

    Reference (BFMMM.h:1414-1442): nu, chi, Phi ~ N(0,1); gamma, delta, A,
    sigma, tau, alpha_3 = 1; pi ~ Dir(c); Z rows ~ Dir(100*pi).
    """
    K, P, M, D = cfg.K, data.P, cfg.M, data.D
    N = data.N
    keys = jax.random.split(key, 8)
    if c is None:
        c = jnp.full((K,), 10.0, dtype=dtype)
    pi = jax.random.dirichlet(keys[0], c)
    Z = jax.random.dirichlet(keys[1], 100.0 * pi, shape=(N,))
    return GibbsState(
        Z=Z.astype(dtype),
        pi=pi.astype(dtype),
        alpha3=jnp.asarray(1.0, dtype),
        nu=jax.random.normal(keys[2], (K, P), dtype),
        tau=jnp.ones((K,), dtype),
        sigma2=jnp.asarray(1.0, dtype),
        chi=jax.random.normal(keys[3], (N, M), dtype),
        Phi=jax.random.normal(keys[4], (K, P, M), dtype),
        gamma=jnp.ones((K, P, M), dtype),
        delta=jnp.ones((K, M), dtype),
        A=jnp.ones((K, 2), dtype),
        eta=jnp.zeros((K, P, D), dtype),
        tau_eta=jnp.ones((K, D), dtype),
        xi=jnp.zeros((K, P, D, M), dtype),
        gamma_xi=jnp.ones((K, P, D, M), dtype),
        delta_xi=jnp.ones((K, M, D), dtype),
        A_xi=jnp.ones((K, 2, D), dtype),
    )
