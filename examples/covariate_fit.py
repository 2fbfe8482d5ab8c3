"""Covariate-adjusted functional mixed membership fit, end to end.

The covariate-adjusted model (reference README.md "Covariate Adjusted
Model"; drivers BFMMM.h:4067 MeanAdj, :4602 Mean_CovAdj) lets both the
feature means (eta, UpdateEta.h) and the feature covariances (xi,
UpdateXi.h) depend on a design matrix X.  Here: simulate data whose mean
and covariance both shift with a scalar covariate, fit the full 3-phase
pipeline with covariate_cov=True, and read off the covariate effect.

Run:  python examples/covariate_fit.py            (default JAX backend)
"""

import numpy as np

from bayesfmmm_tpu import api, basis
from bayesfmmm_tpu.post import summaries
from bayesfmmm_tpu.utils.simulate import simulate_functional


def main():
    # 60 sample paths, K=2 features, M=3 eigenfunctions, D=1 covariate
    # affecting mean (eta) and covariance (xi)
    data, truth = simulate_functional(seed=3, N=60, K=2, P=8, M=3, D=1,
                                      with_eta=True, with_xi=True)

    result = api.fit(data=data, K=2, M=3, covariate_cov=True,
                     nu_z_iters=400, theta_iters=400, warm_iters=800,
                     n_try=2)
    print("final loglik:", np.asarray(result.loglik[-5:]).round(1))

    tq = np.linspace(0, 1, 100)
    B = basis.bspline_basis(tq, 3, np.linspace(0, 1, 6)[1:-1],
                            np.array([0.0, 1.0]))

    # covariate-conditional mean band for feature 1 at X = +1 vs X = -1:
    # mean_k(t | x) = B(t) (nu_k + eta_k x)   (UpdateEta.h model form)
    for x in (-1.0, 1.0):
        ci = summaries.mean_ci(result.traces["nu"], B, k=1, rescale=False,
                               burnin_prop=0.5,
                               eta_samp=np.asarray(result.traces["eta"]),
                               x=np.array([x]))
        print(f"x={x:+.0f}: mean of feature-1 curve "
              f"{float(np.mean(ci['CI_50'])):+.3f}, "
              f"band half-width "
              f"{float(np.median(ci['CI_Upper'] - ci['CI_Lower'])) / 2:.3f}")

    # posterior of the covariance-adjustment magnitude ||xi||
    xi = np.asarray(result.traces["xi"])          # (draws, K, P, D, M)
    half = xi.shape[0] // 2
    print("posterior ||xi|| (draw-median):",
          float(np.median(np.linalg.norm(
              xi[half:].reshape(xi.shape[0] - half, -1), axis=1))))


if __name__ == "__main__":
    main()
