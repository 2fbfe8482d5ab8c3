"""Measured equilibration-transient study: how much warmup is enough?

Round-3 VERDICT next #3: the headline pays a 150k-sweep warmup (~294s) for
a 37s measured window and nothing in the repo tries to shorten it.  This
experiment warms ONE chain ensemble and snapshots it at a ladder of warmup
lengths; from each snapshot it runs a short kept window and reports the
cross-chain R-hat (convergence), the ensemble-mean log-likelihood (the
transient's own order parameter — it climbs until equilibration), and the
between-chain loglik spread.  One JSON line per ladder mark.

Init modes:
  spectral (default) — the bench protocol's spectral init + Z jitter.
  advi               — chains seeded from mean-field ADVI variational
                       samples (samplers/advi.py), testing whether a
                       ~1-minute ADVI run buys down the O(1e5) transient.

Usage: python benchmarks/warmup_transient.py --chains 256 \
          --marks 10000,25000,50000,100000,150000 --kept 5000 --init advi
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CHUNK = 5000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--marks", default="10000,25000,50000,100000,150000")
    ap.add_argument("--kept", type=int, default=5000)
    ap.add_argument("--init", choices=["spectral", "advi"],
                    default="spectral")
    ap.add_argument("--anneal", type=int, default=5000)
    ap.add_argument("--gauge", type=int, default=1)
    ap.add_argument("--collapsed", type=int, default=0)
    ap.add_argument("--p_indep", type=float, default=0.1)
    args = ap.parse_args()
    marks = sorted(int(x) for x in args.marks.split(","))

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.diagnostics import (rank_normalized_ess,
                                           rank_normalized_rhat)
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.utils.init_strategies import spectral_init
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    cfg = ModelConfig(K=K, P=P, M=M)
    gauge = bool(args.gauge)
    dtype = data.y.dtype

    key = jax.random.PRNGKey(0)
    chain_keys = jax.random.split(key, args.chains)
    states = jax.jit(jax.vmap(lambda k: init_state(k, cfg, data)))(chain_keys)

    init_s = 0.0
    if args.init == "spectral":
        sp = spectral_init(data, K, M)
        sp_jax = {k: jnp.asarray(v, dtype) for k, v in sp.items()}

        def seed_chain(st, k):
            jit_z = 0.02 * jax.random.normal(k, sp_jax["Z"].shape, dtype)
            Z0 = jnp.clip(sp_jax["Z"] + jit_z, 1e-4, None)
            return st.replace(
                Z=Z0 / jnp.sum(Z0, axis=1, keepdims=True), nu=sp_jax["nu"],
                chi=sp_jax["chi"], Phi=sp_jax["Phi"],
                sigma2=sp_jax["sigma2"])

        states = jax.jit(jax.vmap(seed_chain))(states, chain_keys)
    else:
        from bayesfmmm_tpu.models import logjoint
        from bayesfmmm_tpu.samplers import advi as advi_mod
        t0 = time.time()
        lj = logjoint.make_log_joint(data, hp, c)
        unc0 = logjoint.init_unc(jax.random.fold_in(key, 10), cfg, data)
        res = advi_mod.run_advi(jax.random.fold_in(key, 11), lj, unc0,
                                n_steps=600, learning_rate=0.03)
        samples = advi_mod.sample_from_advi(jax.random.fold_in(key, 12), res,
                                            n_samples=args.chains)
        states = jax.vmap(logjoint.to_state)(samples)
        jax.block_until_ready(states.Z)
        init_s = time.time() - t0

    probe_obs = jnp.arange(0, N, N // 8)[:8]
    probe_t = jnp.array([0, data.L // 4, data.L // 2, 3 * data.L // 4,
                         data.L - 1])
    B_probe = data.B[probe_obs][:, probe_t, :]

    collapsed = bool(args.collapsed)

    def warm_chain(k, st, b0, b1):
        def body(carry, inp):
            kk, b = inp
            return gibbs.sweep_full(kk, carry, data, hp, c, beta=b,
                                    gauge=gauge, collapsed_z=collapsed,
                                    p_indep=args.p_indep), None
        bs = jnp.linspace(b0, b1, CHUNK).astype(dtype)
        st, _ = jax.lax.scan(body, st, (jax.random.split(k, CHUNK), bs))
        return st

    def kept_chain(k, st):
        def body(carry, kk):
            st = gibbs.sweep_full(kk, carry, data, hp, c, gauge=gauge,
                                  collapsed_z=collapsed,
                                  p_indep=args.p_indep)
            w = st.Z[probe_obs] @ st.nu \
                + jnp.einsum("nk,kpm,nm->np", st.Z[probe_obs], st.Phi,
                             st.chi[probe_obs], precision="highest")
            probes = jnp.einsum("ntp,np->nt", B_probe, w,
                                precision="highest").ravel()
            ll = log_likelihood(st, data)
            return st, jnp.concatenate([probes, ll[None]])
        return jax.lax.scan(body, st, jax.random.split(k, args.kept))

    warm_f = jax.jit(jax.vmap(warm_chain, in_axes=(0, 0, None, None)))
    run_k = jax.jit(jax.vmap(kept_chain))

    def evaluate(states, done, warm_s):
        kkeys = jax.vmap(lambda k: jax.random.fold_in(k, 999))(chain_keys)
        t0 = time.time()
        _, out = run_k(kkeys, states)
        jax.block_until_ready(out)
        kept_s = time.time() - t0
        out = np.asarray(out)
        n_q = out.shape[2]
        rhat_q = [rank_normalized_rhat(out[:, :, j]) for j in range(n_q)]
        ess_q = [rank_normalized_ess(out[:, :, j]) for j in range(n_q)]
        ll = out[:, :, -1]                      # (chains, kept)
        chain_ll = ll.mean(axis=1)
        print(json.dumps({
            "init": args.init, "chains": args.chains, "warmup": done,
            "collapsed_z": collapsed,
            "kept": args.kept, "gauge": gauge,
            "rhat_median": round(float(np.median(rhat_q)), 4),
            "rhat_max": round(float(np.max(rhat_q)), 4),
            "rhat_loglik": round(float(rhat_q[-1]), 4),
            "ess_median": round(float(np.median(ess_q)), 1),
            "loglik_mean": round(float(chain_ll.mean()), 2),
            "loglik_chain_sd": round(float(chain_ll.std()), 3),
            "warm_s": round(warm_s, 1), "kept_s": round(kept_s, 1),
            "init_s": round(init_s, 1),
        }), flush=True)

    done = 0
    warm_s = 0.0
    if marks[0] == 0:
        evaluate(states, 0, 0.0)
        marks = marks[1:]
    for mark in marks:
        while done < mark:
            bseg = np.interp(
                [done, done + CHUNK - 1],
                [0, max(args.anneal - 1, 1), max(marks[-1] - 1, 1)],
                [0.2, 1.0, 1.0])
            t0 = time.time()
            states = warm_f(
                jax.vmap(lambda k: jax.random.fold_in(
                    k, 101 + done // CHUNK))(chain_keys),
                states, float(bseg[0]), float(bseg[1]))
            jax.block_until_ready(states.Z)
            warm_s += time.time() - t0
            done += CHUNK
        evaluate(states, done, warm_s)


if __name__ == "__main__":
    main()
