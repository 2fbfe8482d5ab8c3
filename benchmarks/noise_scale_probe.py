"""Operating-point probe for the round-5 noise/eigen-scale slide kernel.

Measures, on the equilibrated 256-chain headline ensemble (the bench
checkpoint):

  1. MH acceptance of update_noise_scale vs sigma_eps (n_moves=1), and
  2. the decay of the cross-chain sigma2 / log-likelihood spread — the
     round-4 residual R-hat direction (BENCH_SUITE.md round-4 §4.1:
     between-chain loglik sd ~15, sd(log sigma2) ~2%) — over a window of
     production sweeps that now include the kernel.

Usage: python benchmarks/noise_scale_probe.py [--sweeps 2000] [--accept]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--accept", action="store_true",
                    help="acceptance ladder only")
    ap.add_argument("--phi_accept", action="store_true",
                    help="collapsed (Phi, chi) acceptance ladder only")
    ap.add_argument("--mala_accept", action="store_true",
                    help="phi-MALA acceptance ladder only")
    ap.add_argument("--ckpt", default=os.path.expanduser(
        "~/.cache/bfmmm_bench/ens_c256_w150000_g1_z1_p0.3_seed7.npz"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import Priors
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.ops.mean import build_cache
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    states, chain_keys, _ = load_checkpoint(args.ckpt, dtype=data.y.dtype)
    n_chains = int(states.Z.shape[0])

    def spread(states):
        ll = jax.jit(jax.vmap(lambda s: log_likelihood(s, data)))(states)
        s2 = states.sigma2
        return {
            "loglik_mean": float(jnp.mean(ll)),
            "loglik_sd": float(jnp.std(ll)),
            "sigma2_mean": float(jnp.mean(s2)),
            "sd_log_sigma2": float(jnp.std(jnp.log(s2))),
            "phi_norm_mean": float(jnp.mean(
                jnp.linalg.norm(states.Phi.reshape(n_chains, -1), axis=1))),
            "phi_norm_sd": float(jnp.std(
                jnp.linalg.norm(states.Phi.reshape(n_chains, -1), axis=1))),
        }

    out = {"chains": n_chains, "initial": spread(states)}

    if args.accept:
        # acceptance ladder: repeated single-move calls; a changed sigma2
        # means the move accepted
        def acc_rate(sig_eps, reps=64):
            def one(k, st):
                cachev = build_cache(data, st)
                st2, _ = gibbs.update_noise_scale(
                    k, st, data, hp, cachev, 1.0,
                    sigma_eps=sig_eps, n_moves=1)
                return st2.sigma2 != st.sigma2
            f = jax.jit(jax.vmap(one))
            hits = 0
            for r in range(reps):
                ks = jax.vmap(lambda kk: jax.random.fold_in(
                    kk, 31 + r))(chain_keys)
                hits += float(jnp.mean(f(ks, states)))
            return hits / reps

        out["acceptance"] = {str(se): round(acc_rate(se), 3)
                             for se in (0.005, 0.01, 0.02, 0.04, 0.08)}
        print(json.dumps(out, indent=1))
        return

    if args.phi_accept:
        # acceptance ladder for the collapsed (Phi, chi) column moves:
        # a changed Phi after n_moves=1 means the move accepted
        def acc_rate(sig_rw, reps=64):
            def one(k, st):
                cachev = build_cache(data, st)
                st2, _ = gibbs.update_phi_chi(
                    k, st, data, hp, cachev, 1.0,
                    sigma_rw=sig_rw, n_moves=1)
                return jnp.any(st2.Phi != st.Phi)
            f = jax.jit(jax.vmap(one))
            hits = 0
            for r in range(reps):
                ks = jax.vmap(lambda kk: jax.random.fold_in(
                    kk, 47 + r))(chain_keys)
                hits += float(jnp.mean(f(ks, states)))
            return hits / reps

        out["phi_acceptance"] = {str(se): round(acc_rate(se), 3)
                                 for se in (0.05, 0.1, 0.2, 0.4, 0.8)}
        print(json.dumps(out, indent=1))
        return

    if args.mala_accept:
        def acc_rate(step, reps=32):
            def one(k, st):
                cachev = build_cache(data, st)
                st2, _ = gibbs.update_phi_mala(
                    k, st, data, hp, cachev, 1.0, step=step, n_steps=1)
                return jnp.any(st2.Phi != st.Phi)
            f = jax.jit(jax.vmap(one))
            hits = 0
            for r in range(reps):
                ks = jax.vmap(lambda kk: jax.random.fold_in(
                    kk, 61 + r))(chain_keys)
                hits += float(jnp.mean(f(ks, states)))
            return hits / reps

        out["mala_acceptance"] = {str(se): round(acc_rate(se), 3)
                                  for se in (0.02, 0.03, 0.04, 0.05, 0.06, 0.08)}
        print(json.dumps(out, indent=1))
        return

    # spread decay under the production sweep (noise-scale kernel included)
    def make_run(n):
        def chainf(k, st):
            def body(carry, kk):
                return gibbs.sweep_full(kk, carry, data, hp, c, gauge=True,
                                        collapsed_z=True, p_indep=0.3), None
            st, _ = jax.lax.scan(body, st, jax.random.split(k, n))
            return st
        return jax.jit(jax.vmap(chainf))

    runf = make_run(args.chunk)
    t0 = time.time()
    traj = []
    done = 0
    ci = 0
    while done < args.sweeps:
        ks = jax.vmap(lambda kk: jax.random.fold_in(kk, 555 + ci))(chain_keys)
        states = runf(ks, states)
        jax.block_until_ready(states.Z)
        done += args.chunk
        ci += 1
        traj.append({"sweeps": done, **spread(states)})
    out["elapsed_s"] = round(time.time() - t0, 1)
    out["trajectory"] = traj
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
