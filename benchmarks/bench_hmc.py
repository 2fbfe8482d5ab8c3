"""Gradient-path benchmark: whole-model HMC ESS/s on the headline config.

Round-1 VERDICT #8: bench.py measured only the Gibbs path; the whole-model
HMC/NUTS sampler (SURVEY.md §7 "primary path") had no perf numbers.  Prints
one JSON line in the same schema as bench.py.

Usage: python benchmarks/bench_hmc.py [--method hmc|nuts]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="hmc", choices=["hmc", "nuts"])
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--samples", type=int, default=300)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.diagnostics import rank_normalized_ess
    from bayesfmmm_tpu.models import logjoint
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.ops.mean import compute_mu
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    cfg = ModelConfig(K=K, P=P, M=M)
    lj = logjoint.make_log_joint(data, hp, c)
    key = jax.random.PRNGKey(0)
    inits = jax.vmap(lambda k: logjoint.init_unc(k, cfg, data))(
        jax.random.split(key, args.chains))

    if args.method == "nuts":
        from bayesfmmm_tpu.samplers.nuts import run_nuts as runner
        kw = dict(max_depth=8)
    else:
        from bayesfmmm_tpu.samplers.hmc import run_hmc as runner
        kw = dict(n_leapfrog=24)

    t0 = time.time()
    trace, diag = runner(jax.random.fold_in(key, 1), lj, inits,
                         n_warmup=args.warmup, n_samples=args.samples, **kw)
    jax.block_until_ready(jax.tree.leaves(trace)[0])
    first = time.time() - t0
    t0 = time.time()
    trace, diag = runner(jax.random.fold_in(key, 2), lj, inits,
                         n_warmup=args.warmup, n_samples=args.samples, **kw)
    jax.block_until_ready(jax.tree.leaves(trace)[0])
    elapsed = time.time() - t0

    states = jax.jit(jax.vmap(jax.vmap(logjoint.to_state)))(trace)
    probe_obs = jnp.arange(0, N, N // 8)[:8]
    probe_t = jnp.arange(0, data.L, data.L // 4)[:4]

    @jax.jit
    def probes(states):
        def one(s):
            mu = compute_mu(data, s)
            return jnp.concatenate([mu[probe_obs][:, probe_t].ravel(),
                                    log_likelihood(s, data)[None]])
        return jax.vmap(jax.vmap(one))(states)

    q = np.asarray(probes(states))              # (chains, samples, n_q)
    ess_q = [rank_normalized_ess(q[:, :, j]) for j in range(q.shape[2])]
    ess_total = float(np.median(ess_q))
    result = {
        "metric": f"{args.method}_ess_per_sec_functional_K3_P8_N100_"
                  f"{args.chains}chains",
        "value": round(ess_total / elapsed, 2),
        "unit": "ESS/s",
        "vs_baseline": None,
        "detail": {
            "backend": jax.default_backend(),
            "ess_total_identifiable_multichain": round(ess_total, 1),
            "accept_mean": round(float(np.mean(
                np.asarray(diag["accept_mean"]))), 3),
            "elapsed_s": round(elapsed, 2),
            "compile_s": round(first - elapsed, 1),
            "warmup": args.warmup, "samples": args.samples,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
