"""Per-observation allocation (Z-row) basin-flip diagnostic.

Round-5 finding chain: the residual loglik R-hat (~1.10 at 20k windows)
persists although the INSTANTANEOUS profile-loglik tau is only ~16 sweeps
— so the offending component is small-amplitude (~5 loglik units) and
VERY slow.  Candidate: rare per-observation allocation flips (round-4
measured best-vs-worst chains differ in <= 1 of 100 Z rows).  This script
measures it directly:

  1. rank rows by cross-chain disagreement of Z (bimodal rows),
  2. run a window and count per-chain flips of each row's dominant
     feature,
  3. report residence times and the loglik delta between basins.

Usage: python benchmarks/z_flip_diag.py [--sweeps 4000]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=4000)
    ap.add_argument("--chains", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import Priors
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    states, chain_keys, _ = load_checkpoint(os.path.expanduser(
        "~/.cache/bfmmm_bench/ens_c256_w150000_g1_z1_p0.3_seed7.npz"),
        dtype=data.y.dtype)

    # 1. bimodal rows: cross-chain sd of Z entries (max over k per row)
    Z0 = np.asarray(states.Z)                         # (256, N, K)
    row_sd = Z0.std(axis=0).max(axis=1)               # (N,)
    top = np.argsort(row_sd)[::-1][:8]
    out = {"top_rows": [int(i) for i in top],
           "row_sd": [round(float(row_sd[i]), 3) for i in top]}

    pick = np.arange(0, 256, 256 // args.chains)
    sub = jax.tree.map(lambda x: x[pick], states)
    keys = chain_keys[pick]
    rows = jnp.asarray(top)

    def chain(k, st):
        def body(carry, kk):
            s = gibbs.sweep_full(kk, carry, data, hp, c, gauge=True,
                                 collapsed_z=True)
            return s, s.Z[rows]                        # (8, K)
        return jax.lax.scan(body, st, jax.random.split(k, args.sweeps))

    _, traj = jax.jit(jax.vmap(chain))(keys, sub)
    traj = np.asarray(traj)                            # (C, T, 8, K)
    dom = np.argmax(traj, axis=-1)                     # (C, T, 8)
    res = []
    for j, n in enumerate(top):
        flips = (dom[:, 1:, j] != dom[:, :-1, j]).sum(axis=1)  # per chain
        frac = [float(np.mean(dom[:, :, j] == kk))
                for kk in range(K)]
        res.append({
            "row": int(n),
            "flips_per_chain_mean": round(float(flips.mean()), 2),
            "chains_with_zero_flips": int(np.sum(flips == 0)),
            "dominant_frac": [round(f, 3) for f in frac],
        })
    out["rows"] = res
    out["sweeps"] = args.sweeps
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
