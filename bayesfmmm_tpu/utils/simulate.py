"""Model simulators for tests and benchmarks.

Mirrors the reference's recovery-test data generators (src/test-Nu.cpp:9-105
and friends): fix ground-truth parameters, simulate observations from the
exact model, and return (data, truth) so conditional updaters can be tested
for posterior recovery.
"""

from __future__ import annotations

import numpy as np

from bayesfmmm_tpu.models.state import (
    GibbsState,
    make_functional_data,
    make_hd_functional_data,
    make_multivariate_data,
)


def _numpy_mu(data, state):
    """Host-side model mean (avoids eager dispatch to a remote device)."""
    B = np.asarray(data.B)
    X = np.asarray(data.X)
    Z = np.asarray(state.Z)
    chi = np.asarray(state.chi)
    w = np.einsum("nk,kp->np", Z, np.asarray(state.nu))
    w += np.einsum("nk,kpm,nm->np", Z, np.asarray(state.Phi), chi)
    if X.shape[1] > 0:
        w += np.einsum("nk,kpd,nd->np", Z, np.asarray(state.eta), X)
        w += np.einsum("nk,kpdm,nd,nm->np", Z, np.asarray(state.xi), X, chi)
    return np.einsum("nlp,np->nl", B, w)


def _truth_state(rng, N, K, P, M, D, dtype, *, nu_scale=3.0, phi_scale=0.5,
                 sigma2=0.01, with_eta=False, with_xi=False):
    # Host-side NumPy leaves: no per-array device transfers at build time;
    # jit boundaries convert on first use.
    nu = nu_scale * rng.normal(size=(K, P))
    Phi = phi_scale * rng.normal(size=(K, P, M))
    Z = rng.dirichlet(np.full(K, 1.0), size=N)
    chi = rng.normal(size=(N, M))
    pi = np.full(K, 1.0 / K)
    eta = rng.normal(size=(K, P, D)) if with_eta else np.zeros((K, P, D))
    xi = (0.5 * rng.normal(size=(K, P, D, M))) if with_xi \
        else np.zeros((K, P, D, M))
    a = lambda x: np.asarray(x, dtype)
    return GibbsState(
        Z=a(Z), pi=a(pi), alpha3=a(2.0), nu=a(nu),
        tau=np.ones((K,), dtype), sigma2=a(sigma2), chi=a(chi), Phi=a(Phi),
        gamma=np.ones((K, P, M), dtype), delta=np.ones((K, M), dtype),
        A=np.ones((K, 2), dtype), eta=a(eta),
        tau_eta=np.ones((K, D), dtype), xi=a(xi),
        gamma_xi=np.ones((K, P, D, M), dtype),
        delta_xi=np.ones((K, M, D), dtype),
        A_xi=np.ones((K, 2, D), dtype),
    )


def simulate_functional(seed=1, *, N=40, K=3, P=8, M=2, D=0, n_time=(80, 100),
                        sigma2=0.01, nu_scale=3.0, phi_scale=0.5,
                        with_eta=False, with_xi=False, dtype=None):
    """Simulate functional MM data on [0, 1] with a cubic B-spline basis.

    Returns (data, truth_state).  P = n_internal + degree + 1 determines the
    internal knot count (degree fixed at 3).
    """
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    rng = np.random.default_rng(seed)
    degree = 3
    n_internal = P - degree - 1
    assert n_internal >= 0, "P must be >= 4 for a cubic basis"
    internal = np.linspace(0, 1, n_internal + 2)[1:-1]
    boundary = np.array([0.0, 1.0])

    t_list = [np.sort(rng.uniform(0, 1, rng.integers(n_time[0], n_time[1] + 1)))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None

    # Build design to generate data, then rebuild the container with y.
    data0 = make_functional_data([np.zeros_like(t) for t in t_list], t_list,
                                 basis_degree=degree, internal_knots=internal,
                                 boundary_knots=boundary, X=X, dtype=dtype)
    truth = _truth_state(rng, N, K, P, M, D, dtype, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi)
    mu = _numpy_mu(data0, truth)   # host-side: no eager device dispatch
    mask = np.asarray(data0.mask)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    y_list = [y[i][mask[i] > 0] for i in range(N)]
    data = make_functional_data(y_list, t_list, basis_degree=degree,
                                internal_knots=internal,
                                boundary_knots=boundary, X=X, dtype=dtype)
    return data, truth


def simulate_hd_functional(seed=1, *, N=20, K=2, M=2, D=0, n_points=(40, 50),
                           sigma2=0.01, nu_scale=3.0, phi_scale=0.5,
                           basis_degrees=(2, 2), n_internal=(1, 1),
                           with_eta=False, with_xi=False, dtype=None):
    """Simulate surface (2-D domain) MM data with a tensor B-spline basis.

    Reference family: BHDFMMM (BFMMM.h:2892; basis via TensorBSpline
    BSplines.h:18-62, penalty via GetP BSplines.h:70-120).  Each surface i
    is observed at n_i random points in [0,1]^2.
    """
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    rng = np.random.default_rng(seed)
    dim = len(basis_degrees)
    internal = [np.linspace(0, 1, n + 2)[1:-1] for n in n_internal]
    boundary = np.tile(np.array([0.0, 1.0]), (dim, 1))
    t_list = [rng.uniform(0, 1, (int(rng.integers(n_points[0],
                                                  n_points[1] + 1)), dim))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None
    data0 = make_hd_functional_data(
        [np.zeros(t.shape[0]) for t in t_list], t_list,
        basis_degrees=basis_degrees, internal_knots_list=internal,
        boundary_knots=boundary, X=X, dtype=dtype)
    P = int(data0.P)
    truth = _truth_state(rng, N, K, P, M, D, dtype, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi)
    mu = _numpy_mu(data0, truth)
    mask = np.asarray(data0.mask)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    y_list = [y[i][mask[i] > 0] for i in range(N)]
    data = make_hd_functional_data(
        y_list, t_list, basis_degrees=basis_degrees,
        internal_knots_list=internal, boundary_knots=boundary, X=X,
        dtype=dtype)
    return data, truth


def simulate_multivariate(seed=1, *, N=200, K=2, P=6, M=2, D=0, sigma2=0.01,
                          nu_scale=3.0, phi_scale=0.5, with_eta=False,
                          with_xi=False, dtype=None):
    """Simulate multivariate MM data (identity basis)."""
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)) if D else None
    data0 = make_multivariate_data(np.zeros((N, P)), X=X, dtype=dtype)
    truth = _truth_state(rng, N, K, P, M, D, dtype, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi)
    mu = _numpy_mu(data0, truth)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape)
    data = make_multivariate_data(y, X=X, dtype=dtype)
    return data, truth
