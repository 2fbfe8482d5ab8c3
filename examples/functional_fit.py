"""Fit a functional mixed membership model end to end.

Mirrors the reference's BFMMM_Nu_Z_multiple_try -> BFMMM_Theta_est ->
BFMMM_warm_start example pipeline (UserFunctions.cpp:101-163) on simulated
sample paths, then computes posterior summaries.

Run:  python examples/functional_fit.py            (default JAX backend)
      JAX_PLATFORMS=cpu + jax.config override for CPU-only boxes
"""

import numpy as np

import jax

from bayesfmmm_tpu import api, basis
from bayesfmmm_tpu.post import model_selection, summaries
from bayesfmmm_tpu.utils.simulate import simulate_functional


def main():
    # 40 sample paths on [0, 1], K=2 latent features, M=3 eigenfunctions
    data, truth = simulate_functional(seed=1, N=40, K=2, P=8, M=3)

    result = api.fit(data=data, K=2, M=3, nu_z_iters=500, theta_iters=500,
                     warm_iters=1000, n_try=2)
    print("final loglik:", np.asarray(result.loglik[-5:]).round(1))

    # credible band for feature 1's mean function
    tq = np.linspace(0, 1, 100)
    B = basis.bspline_basis(tq, 3, np.linspace(0, 1, 6)[1:-1],
                            np.array([0.0, 1.0]))
    ci = summaries.mean_ci(result.traces["nu"], B, k=1, rescale=True,
                           Z_samp=result.traces["Z"], burnin_prop=0.5)
    print("mean CI half-width (median):",
          float(np.median(ci["CI_Upper"] - ci["CI_Lower"])) / 2)

    # model selection
    print("DIC:", model_selection.dic(result.traces, data, burnin_prop=0.5))
    print("AIC:", model_selection.aic(result.traces, data, burnin_prop=0.5))
    print("BIC:", model_selection.bic(result.traces, data, burnin_prop=0.5))


if __name__ == "__main__":
    main()
