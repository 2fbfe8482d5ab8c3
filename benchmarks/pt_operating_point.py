"""Parallel-tempering operating point for the headline benchmark.

Round-4 finding (BENCH_SUITE.md §1/§4): multichain ESS saturates at ~7.3k
regardless of window length because a persistent between-chain fit-level
spread (loglik sd ~15 at 150k warmup) caps the multichain estimator at ~5%
of the within-chain ESS sum.  The principled fix for that multimodality is
replica exchange: hot rungs hop allocation basins freely (the annealed
warmup already shows beta ~0.2-0.3 mixes them), and swaps carry the
equalized states down to beta=1 — so the COLD chains should agree
(R-hat -> 1) at stationarity, uncapping the estimator.

This probe reshapes the bench's equilibrated 256-chain checkpoint into
S = 256/R independent PT systems of R replicas each, runs vmapped PT
rounds (1 tempered sweep per replica per round + 1 swap phase), and
reports the same probe R-hat / multichain ESS / ESS/s estimator as
bench.py over the S cold chains.

Usage: python benchmarks/pt_operating_point.py [--replicas 4]
          [--beta_min 0.25] [--rounds 5000] [--ckpt <path>]
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

CHUNK = 1250


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--beta_min", type=float, default=0.25)
    ap.add_argument("--rounds", type=int, default=5000)
    ap.add_argument("--chains", type=int, default=256,
                    help="total chain slots (= systems * replicas)")
    ap.add_argument("--ckpt", default=os.path.expanduser(
        "~/.cache/bfmmm_bench/ens_c256_w150000_g1_z1_p0.3_seed7.npz"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.diagnostics import (rank_normalized_ess,
                                           rank_normalized_rhat)
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.parallel import tempering

    K, P, M, N = 3, 8, 4, 100
    from bayesfmmm_tpu.utils.simulate import simulate_functional
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    dtype = data.y.dtype

    R = args.replicas
    S = args.chains // R
    states, _, _ = load_checkpoint(args.ckpt, dtype=dtype)
    sys_states = jax.tree.map(
        lambda x: x[:S * R].reshape(S, R, *x.shape[1:]), states)
    ladder = tempering.geometric_ladder(R, args.beta_min).astype(dtype)

    probe_obs = jnp.arange(0, N, N // 8)[:8]
    probe_t = jnp.array([0, data.L // 4, data.L // 2, 3 * data.L // 4,
                         data.L - 1])
    B_probe = data.B[probe_obs][:, probe_t, :]

    def system_chunk(k, pt, n):
        def body(carry, inp):
            i, kk = inp
            pt = tempering.pt_step(kk, carry, data, hp, c, ladder,
                                   parity=i % 2, collapsed_z=True,
                                   gauge=True)
            cold = jax.tree.map(lambda x: x[0], pt.states)
            w = cold.Z[probe_obs] @ cold.nu \
                + jnp.einsum("nk,kpm,nm->np", cold.Z[probe_obs], cold.Phi,
                             cold.chi[probe_obs], precision="highest")
            probes = jnp.einsum("ntp,np->nt", B_probe, w,
                                precision="highest").ravel()
            ll = log_likelihood(cold, data)
            return pt, jnp.concatenate([probes, ll[None]])
        return jax.lax.scan(body, pt,
                            (jnp.arange(n), jax.random.split(k, n)))

    def make_run(n):
        return jax.jit(jax.vmap(lambda k, pt: system_chunk(k, pt, n)))

    key = jax.random.PRNGKey(11)
    sys_keys = jax.random.split(key, S)
    pts = jax.vmap(tempering.pt_init)(sys_states)

    t0 = time.time()
    run = make_run(CHUNK)
    compiled = run.lower(sys_keys, pts).compile()
    rem = args.rounds % CHUNK
    rem_f = make_run(rem).lower(sys_keys, pts).compile() if rem else None
    compile_s = time.time() - t0

    chunks, done, ci = [], 0, 0
    t0 = time.time()
    while done < args.rounds:
        n = min(CHUNK, args.rounds - done)
        f = compiled if n == CHUNK else rem_f
        kk = jax.vmap(lambda k: jax.random.fold_in(k, 31 + ci))(sys_keys)
        pts, out = f(kk, pts)
        jax.block_until_ready(out)
        chunks.append(out)
        done += n
        ci += 1
    elapsed = time.time() - t0
    out = np.concatenate([np.asarray(o) for o in chunks], axis=1)

    n_q = out.shape[2]
    ess_q = [rank_normalized_ess(out[:, :, j]) for j in range(n_q)]
    rhat_q = [rank_normalized_rhat(out[:, :, j]) for j in range(n_q)]
    swap_rate = float(np.mean(np.asarray(pts.swap_accepts)
                              / np.maximum(np.asarray(pts.swap_attempts),
                                           1.0)))
    ess_total = float(np.median(ess_q))
    print(json.dumps({
        "metric": "pt_operating_point",
        "systems": S, "replicas": R, "beta_min": args.beta_min,
        "rounds": args.rounds,
        "rhat_median": round(float(np.median(rhat_q)), 4),
        "rhat_max": round(float(np.max(rhat_q)), 4),
        "rhat_loglik": round(float(rhat_q[-1]), 4),
        "ess_multichain": round(ess_total, 1),
        "ess_per_sec": round(ess_total / elapsed, 1),
        "swap_rate": round(swap_rate, 3),
        "elapsed_s": round(elapsed, 1),
        "compile_s": round(compile_s, 1),
        "cold_sweeps_per_sec": round(S * args.rounds / elapsed, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
