"""Per-kernel wall-clock breakdown of the production sweep on the chip.

The chain-scaling ladder (benchmarks/chain_scaling.py) shows chain-sweeps/s
saturating at ~44k by 128-256 chains — the sweep is per-chain-WORK bound,
not dispatch-latency bound, at a measured 0.08% of bf16 peak.  The FLOPs
are trivial, so the time lives in non-MXU work (gamma rejection sampling,
batched small Cholesky/triangular solves, transcendentals).  This script
times each kernel in isolation (scanned, vmapped over chains, same shapes
as the headline) to locate it.  One JSON line per kernel.

Usage: python benchmarks/kernel_breakdown.py [--chains 256] [--sweeps 500]
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
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--sweeps", type=int, default=500)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.ops import gibbs
    from bayesfmmm_tpu.ops.mean import build_cache
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    hp = Priors()
    c = jnp.full((K,), 10.0)
    cfg = ModelConfig(K=K, P=P, M=M)

    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    states0 = jax.jit(jax.vmap(lambda k: init_state(k, cfg, data)))(keys)

    def k_cache(key, st):
        cache = build_cache(data, st)
        return st.replace(sigma2=st.sigma2 + 0.0 * jnp.sum(cache.w))

    def mk(fn, with_cache=True, needs_c=False):
        def kernel(key, st):
            cache = build_cache(data, st)
            if needs_c:
                out = fn(key, st, hp, c)
            elif with_cache:
                out = fn(key, st, data, hp, cache)
            else:
                out = fn(key, st, hp)
            if isinstance(out, tuple):
                st = out[0].replace(sigma2=out[0].sigma2
                                    + 0.0 * jnp.sum(out[1].w))
            else:
                st = out
            return st
        return kernel

    kernels = {
        "cache_only": k_cache,
        "z": mk(gibbs.update_z),
        "z_chi_collapsed": mk(gibbs.update_z_chi),
        "pi": mk(gibbs.update_pi, needs_c=True),
        "alpha3": mk(gibbs.update_alpha3, with_cache=False),
        "phi_joint": mk(gibbs.update_phi),
        "delta": mk(gibbs.update_delta, with_cache=False),
        "a": mk(gibbs.update_a, with_cache=False),
        "gamma": mk(gibbs.update_gamma, with_cache=False),
        "nu": mk(gibbs.update_nu),
        "tau": lambda key, st: gibbs.update_tau(key, st, data, hp),
        "sigma": mk(gibbs.update_sigma),
        "chi_seq": mk(gibbs.update_chi),
        "chi_joint": mk(gibbs.update_chi_joint),
        "gauge": lambda key, st: gibbs.update_gauge(key, st, data, hp),
        "mgp_scale": mk(gibbs.update_mgp_scale),
        "noise_scale": mk(gibbs.update_noise_scale),
        "full_sweep_gauge": lambda key, st: gibbs.sweep_full(
            key, st, data, hp, c, gauge=True),
        "full_sweep_plain": lambda key, st: gibbs.sweep_full(
            key, st, data, hp, c, gauge=False),
        "full_sweep_production": lambda key, st: gibbs.sweep_full(
            key, st, data, hp, c, gauge=True, collapsed_z=True),
    }

    for name, kernel in kernels.items():
        def chain(k, st):
            def body(carry, kk):
                return kernel(kk, carry), None
            st, _ = jax.lax.scan(body, st, jax.random.split(k, args.sweeps))
            return st
        run = jax.jit(jax.vmap(chain))
        t0 = time.time()
        out = run(keys, states0)
        jax.block_until_ready(out.sigma2)
        compile_s = time.time() - t0
        kk = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
        t0 = time.time()
        out = run(kk, states0)
        jax.block_until_ready(out.sigma2)
        dt = time.time() - t0
        print(json.dumps({
            "kernel": name, "chains": args.chains, "sweeps": args.sweeps,
            "time_s": round(dt, 3),
            "us_per_chain_sweep": round(1e6 * dt / (args.chains
                                                    * args.sweeps), 2),
            "compile_s": round(compile_s, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
