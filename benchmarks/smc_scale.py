"""SMC at the config-5 scale it exists for (round-4 VERDICT #6).

BASELINE.json config 5: BHDFMMM 2-D surfaces, K=4, 256 particles.  This
study runs adaptive tempered SMC with the production mutation kernels
(collapsed (Z, chi) + gauge + interweaves) from the PRIOR (no initializer)
and answers: does SMC work as the multimodality tool at scale?

Measured: stage count, final beta, log-evidence, weight-ESS, wall clock,
weight-ESS/s, and posterior parity — the weighted particle mean of the
fitted surfaces against a long warm-started Gibbs run's posterior mean
(relative RMS; both runs see the same data).

Usage: python benchmarks/smc_scale.py [--particles 256] [--mutation 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--mutation", type=int, default=3)
    ap.add_argument("--gibbs_sweeps", type=int, default=4000)
    ap.add_argument("--gibbs_chains", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from suite import CONFIGS, build

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.ops.mean import effective_coeffs
    from bayesfmmm_tpu.samplers.smc import ess_from_log_weights, run_smc

    cfg5 = CONFIGS[5]
    data, truth = build(cfg5)
    K, M = cfg5["K"], cfg5["M"]
    hp = Priors()
    c = jnp.full((K,), 10.0)
    mc = ModelConfig(K=K, P=int(data.P), M=M, D=int(data.D), family="hd")
    key = jax.random.PRNGKey(0)

    # ---- SMC from the prior, production mutation kernels ----
    init_keys = jax.random.split(jax.random.fold_in(key, 999),
                                 args.particles)
    particles = jax.jit(jax.vmap(
        lambda k: init_state(k, mc, data, c=c)))(init_keys)
    smc_fn = jax.jit(lambda k, p: run_smc(
        k, p, data, hp, c, n_mutation_sweeps=args.mutation,
        collapsed_z=True, gauge=True))
    t0 = time.time()
    res = smc_fn(key, particles)
    jax.block_until_ready(res.log_weights)
    smc_s = time.time() - t0
    w = np.asarray(jax.nn.softmax(res.log_weights))
    wess = float(ess_from_log_weights(res.log_weights))

    # weighted posterior-mean fitted coefficients (gauge-invariant)
    W_all = np.asarray(jax.jit(jax.vmap(
        lambda s: effective_coeffs(s, data.X)))(res.particles))
    smc_mean = np.tensordot(w, W_all, axes=1)          # (N, P)

    # ---- long warm-started Gibbs reference on the same data ----
    gkeys = jax.random.split(jax.random.fold_in(key, 77),
                             args.gibbs_chains)
    gstates = jax.jit(jax.vmap(
        lambda k: init_state(k, mc, data, c=c)))(gkeys)

    def chain(k, st):
        def body(carry, kk):
            s = gibbs.sweep_full(kk, carry, data, hp, c, gauge=True,
                                 collapsed_z=True)
            return s, None
        st, _ = jax.lax.scan(
            body, st, jax.random.split(k, args.gibbs_sweeps))
        return effective_coeffs(st, data.X)

    # average the last-state fitted coeffs over chains and over a few
    # strided continuation snapshots for a stable posterior mean
    rung = jax.jit(jax.vmap(chain))
    t0 = time.time()
    snaps = []
    st = gstates
    for r in range(4):
        kk = jax.vmap(lambda k: jax.random.fold_in(k, 100 + r))(gkeys)
        Wg = rung(kk, st)
        jax.block_until_ready(Wg)
        snaps.append(np.asarray(Wg))
    gibbs_s = time.time() - t0
    gibbs_mean = np.concatenate(snaps, axis=0).mean(axis=0)

    num = float(np.sqrt(np.mean((smc_mean - gibbs_mean) ** 2)))
    den = float(np.sqrt(np.mean(gibbs_mean ** 2)))

    out = {
        "config": cfg5["name"],
        "particles": args.particles,
        "mutation_sweeps": args.mutation,
        "n_stages": int(res.n_stages),
        "final_beta": float(res.final_beta),
        "log_evidence": round(float(res.log_evidence), 1),
        "weight_ess": round(wess, 1),
        "smc_wall_s": round(smc_s, 1),
        "weight_ess_per_sec": round(wess / smc_s, 2),
        "gibbs_ref": {"chains": args.gibbs_chains,
                      "sweeps_per_snap": args.gibbs_sweeps,
                      "wall_s": round(gibbs_s, 1)},
        "fitted_coeff_rel_rms_vs_gibbs": round(num / den, 4),
        "verdict_pass": bool(num / den < 0.05 and float(res.final_beta)
                             >= 1.0),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
