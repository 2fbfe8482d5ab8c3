"""Multimodality toolkit: parallel tempering and SMC fits.

The reference attacks multimodal allocation posteriors with in-chain
tempered transitions (BFMMM_warm_start's n_temp_trans/N_t/beta_N_t).  The
rebuild keeps those (api.fit_warm_start) and adds the two device-parallel
equivalents:

  * api.fit_pt  — replica-exchange parallel tempering: R tempered replicas
    run concurrently; adjacent replicas swap states each round (the swap is
    a collective-permute when replicas shard across a mesh).
  * api.fit_smc — adaptive tempered SMC from the prior to the posterior:
    no warm-start pipeline needed, and the log-evidence estimate comes out
    for free (model selection across K without fitting DIC/BIC).

Run: python examples/tempering_fit.py            (CPU-friendly sizes)
"""

import numpy as np

from bayesfmmm_tpu import api
from bayesfmmm_tpu.utils.simulate import simulate_multivariate


def main():
    data, truth = simulate_multivariate(seed=5, N=60, K=2, P=6, M=2)

    # --- 3-phase pipeline feeding parallel tempering ---
    r1 = api.fit_nu_z(data=data, K=2, M=2, family="multivariate",
                      tot_mcmc_iters=300, n_try=2, seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=300, seed=1)
    pt = api.fit_pt(r1, r2, tot_mcmc_iters=500, n_replicas=6,
                    beta_min=0.4, seed=2)
    ll = np.asarray(pt.loglik)
    print(f"PT: swap rate {pt.swap_rate:.2f}, "
          f"cold-chain loglik tail {ll[-100:].mean():.1f}")
    est = pt.estimates(burnin_prop=0.5)
    print("PT posterior-median sigma2:", float(np.asarray(est['sigma2'])))

    # --- SMC straight from the prior, with log-evidence ---
    for K in (2, 3):
        sm = api.fit_smc(data=data, K=K, M=2, family="multivariate",
                         n_particles=128, seed=3)
        print(f"SMC K={K}: {sm['n_stages']} stages, "
              f"log-evidence {sm['log_evidence']:.1f}")


if __name__ == "__main__":
    main()
