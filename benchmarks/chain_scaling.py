"""Measured sweep throughput vs chain count on the real chip.

Round-3 VERDICT weak #2 / next #1: every recorded operating point ran 64
chains while the chip sat latency-bound at 0.065% of bf16 peak; multichain
ESS at fixed stationarity scales ~linearly in chains, so chain count is the
largest unclaimed factor on the board.  This probe times the PRODUCTION
sweep (gauge moves on, the headline kernel combination) at a ladder of
chain counts and prints chain-sweeps/s per point — the scaling evidence
that picks the round-4 headline chain count.

Usage: python benchmarks/chain_scaling.py [--chains 64,128,256,512]
                                          [--sweeps 2000] [--gauge 1]
Prints one JSON line per chain count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", default="64,128,256,512")
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--gauge", type=int, default=1)
    ap.add_argument("--collapsed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    cfg = ModelConfig(K=K, P=P, M=M)
    gauge = bool(args.gauge)
    collapsed = bool(args.collapsed)

    def chain(k, st):
        def body(carry, kk):
            return gibbs.sweep_full(kk, carry, data, hp, c, gauge=gauge,
                                    collapsed_z=collapsed), None
        st, _ = jax.lax.scan(body, st, jax.random.split(k, args.sweeps))
        return st

    for nc in (int(x) for x in args.chains.split(",")):
        keys = jax.random.split(jax.random.PRNGKey(0), nc)
        states = jax.jit(jax.vmap(lambda k: init_state(k, cfg, data)))(keys)
        run = jax.jit(jax.vmap(chain), donate_argnums=(1,))
        t0 = time.time()
        compiled = run.lower(keys, states).compile()
        compile_s = time.time() - t0
        states = compiled(keys, states)          # warm run (also re-inits)
        jax.block_until_ready(states.Z)
        kk = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
        t0 = time.time()
        states = compiled(kk, states)
        jax.block_until_ready(states.Z)
        dt = time.time() - t0
        print(json.dumps({
            "chains": nc, "sweeps": args.sweeps, "gauge": gauge,
            "collapsed_z": collapsed,
            "time_s": round(dt, 3),
            "sweeps_per_sec": round(args.sweeps / dt, 1),
            "chain_sweeps_per_sec": round(nc * args.sweeps / dt, 1),
            "compile_s": round(compile_s, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
