"""Benchmark: ESS/s of the GPU Gibbs sampler vs a single-thread CPU baseline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "ESS/s", "vs_baseline": N}

Config matches BASELINE.json's headline metric ("ESS/s per chip on the
functional MM, K=3 P=8") at the reference's own SNR regime (the shipped
example's sigma2 ~ 0.003; ours 0.01).  The baseline denominator is
*measured* each run (BASELINE.md: the reference publishes no numbers): the
same sweep in vectorized single-thread NumPy (benchmarks/numpy_baseline.py),
a stronger baseline than the reference's scalar-loop Rcpp sampler.

Needs a GPU: it exits non-zero on any other backend, and its output names
the platform, device kind and count, and the card's name and power limit.

Protocol:
  * ESS is the MULTI-CHAIN rank-normalized estimator on identifiable
    quantities (fitted curves at probe points + loglik) — between-chain
    disagreement penalizes the total; label switching cannot deflate it.
  * CHAIN COUNT: default 256 — well-resolved cross-chain diagnostics;
    benchmarks/chain_scaling.py measures chain-sweeps/s against the count.
  * KERNELS: the partially collapsed (Z, chi) block with a 30%
    independence-proposal mixture + gauge moves — the measured round-4
    operating-point winner (rhat_max 1.066 / ESS 7500 vs 1.63 / 1807 for
    the reference chi-conditional kernel at the same 20k/5k budget; see
    update_z_chi docstring).  BENCH_COLLAPSED=0 reverts.
  * This posterior has a measured O(1e5)-sweep equilibration transient
    plus warmup-assigned metastable basins (the round-5 finding: a short
    anneal freezes chains into slightly-off collective configurations
    whose loglik offsets persist for >1e5 sweeps).  The bench therefore
    runs a DEEP ANNEALED WARMUP (beta 0.1 -> 1 over 40k sweeps, then
    plain sweeps), and measures
    kept windows at stationarity.  Warmup cost is reported separately and AMORTIZED: the
    equilibrated ensemble is saved with the exact-state checkpoint
    (io/checkpoint.py) and reused on subsequent runs (cold vs warm mode in
    the detail), the standard production pattern the reference's own
    warm-start phase exists for (UserFunctions.cpp:1341).
  * REPEATABILITY: the kept window and the CPU baseline are each run
    BENCH_REPEATS (default 3) times; the headline is the median with the
    min-max spread recorded.
  * Cross-chain rank-normalized R-hat is reported alongside: median and
    max over probes, plus loglik's own R-hat (the slowest direction).
  * Utilization uses ANALYTIC per-sweep FLOPs (benchmarks/flops.py;
    validated within 2x of XLA's one-sweep cost analysis, incl. the gauge
    term) times trip count — XLA's cost_analysis does not scale scan
    bodies.

Env knobs: BENCH_WARMUP (default 150000; the transient study
benchmarks/warmup_transient.py records how R-hat falls with warmup),
BENCH_KEPT (default 20000), BENCH_CHAINS (default 256), BENCH_GAUGE=0/1
(default 1), BENCH_COLLAPSED=0/1 (default 1), BENCH_P_INDEP (default 0.3),
BENCH_REPEATS (default 3), BENCH_CKPT (checkpoint path; "0" disables
warm-start amortization).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")          # keep baseline 1-thread
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np

WARMUP = int(os.environ.get("BENCH_WARMUP", 150000))
KEPT = int(os.environ.get("BENCH_KEPT", 20000))
N_CHAINS = int(os.environ.get("BENCH_CHAINS", 256))
GAUGE = os.environ.get("BENCH_GAUGE", "1") == "1"
COLLAPSED = os.environ.get("BENCH_COLLAPSED", "1") == "1"
P_INDEP = float(os.environ.get("BENCH_P_INDEP", 0.3))
PHI_MOVES = int(os.environ.get("BENCH_PHI_MOVES", 0))
PHI_SIGMA = float(os.environ.get("BENCH_PHI_SIGMA", 0.1))
MALA_STEPS = int(os.environ.get("BENCH_MALA_STEPS", 4))
MALA_STEP = float(os.environ.get("BENCH_MALA_STEP", 0.05))
HMC_STEPS = int(os.environ.get("BENCH_HMC_STEPS", 0))
HMC_EPS = float(os.environ.get("BENCH_HMC_EPS", 0.003))
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
ANNEAL = min(int(os.environ.get("BENCH_ANNEAL", 40000)), WARMUP)
CHUNK = int(os.environ.get("BENCH_CHUNK", 5000))


def _ckpt_path():
    v = os.environ.get("BENCH_CKPT", "")
    if v == "0":
        return None
    if v:
        return v
    tag = (f"c{N_CHAINS}_w{WARMUP}_g{int(GAUGE)}_z{int(COLLAPSED)}"
           f"_p{P_INDEP}_seed7")
    return os.path.expanduser(f"~/.cache/bfmmm_bench/ens_{tag}.npz")


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import check_device, gpu_identity
    device = check_device()
    card = gpu_identity()

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.diagnostics import (rank_normalized_ess,
                                           rank_normalized_rhat)
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint, save_checkpoint
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

    key = jax.random.PRNGKey(0)
    chain_keys = jax.random.split(key, N_CHAINS)
    dtype = data.y.dtype

    probe_obs = jnp.arange(0, N, N // 8)[:8]
    probe_t = jnp.array([0, data.L // 4, data.L // 2, 3 * data.L // 4,
                         data.L - 1])
    # Probe fitted values via the 8x5 selected basis rows only — O(40*P)
    # per sweep instead of materializing the full (N, L) mean.
    B_probe = data.B[probe_obs][:, probe_t, :]             # (8, 5, P)

    # ---- equilibrated ensemble: load from checkpoint, or warm up cold ----
    ckpt = _ckpt_path()
    warm_mode = "warm" if (ckpt and os.path.exists(ckpt)) else "cold"
    if warm_mode == "warm":
        t0 = time.time()
        states, _, _ = load_checkpoint(ckpt, dtype=dtype)
        warm_s = time.time() - t0
    else:
        states = jax.jit(jax.vmap(lambda k: init_state(k, cfg, data)))(
            chain_keys)
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

        # annealed, chunked warmup; last chunk sized to the remainder so
        # the executed sweep count equals the requested protocol value
        def make_warm(n):
            def warm_chain(k, st, b0, b1):
                def body(carry, inp):
                    kk, b = inp
                    return gibbs.sweep_full(
                        kk, carry, data, hp, c, beta=b, gauge=GAUGE,
                        collapsed_z=COLLAPSED, p_indep=P_INDEP,
                        phi_chi_moves=PHI_MOVES, phi_chi_sigma=PHI_SIGMA,
                        phi_mala_steps=MALA_STEPS,
                        phi_mala_step=MALA_STEP), None
                bs = jnp.linspace(b0, b1, n).astype(dtype)
                st, _ = jax.lax.scan(body, st, (jax.random.split(k, n), bs))
                return st
            return jax.jit(jax.vmap(warm_chain, in_axes=(0, 0, None, None)))

        warm_f = make_warm(CHUNK)
        t0 = time.time()
        done, ci = 0, 0
        while done < WARMUP:
            n = min(CHUNK, WARMUP - done)
            f = warm_f if n == CHUNK else make_warm(n)
            bseg = np.interp([done, done + n - 1],
                             [0, max(ANNEAL - 1, 1), max(WARMUP - 1, 1)],
                             [float(os.environ.get("BENCH_BETA0", 0.1)), 1.0, 1.0])
            states = f(
                jax.vmap(lambda k: jax.random.fold_in(k, 101 + ci))(
                    chain_keys),
                states, float(bseg[0]), float(bseg[1]))
            jax.block_until_ready(states.Z)
            done += n
            ci += 1
        warm_s = time.time() - t0
        if ckpt:
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            save_checkpoint(ckpt, states, chain_keys, iteration=WARMUP)

    # whole-model HMC hybrid for the measurement windows (mass frozen
    # from the equilibrated ensemble — standard adaptation-freeze)
    hmc_inv_mass = None
    if HMC_STEPS:
        from jax.flatten_util import ravel_pytree

        from bayesfmmm_tpu.models import logjoint as lj_mod
        flats = jax.jit(jax.vmap(
            lambda s: ravel_pytree(lj_mod.from_state(s))[0]))(states)
        hmc_inv_mass = jnp.var(flats, axis=0) + 1e-8

    # ---- measured kept windows (REPEATS of them, chained) ----
    # Chunked like the warmup: one compiled CHUNK-sweep program (plus one
    # for a remainder) serves any BENCH_KEPT, so changing the window length
    # does not recompile the full scan.  Chunk outputs stay on device until
    # after the timed section.
    def make_kept(n):
        def kept_chain(k, st):
            def body(carry, kk):
                st = gibbs.sweep_full(kk, carry, data, hp, c, gauge=GAUGE,
                                      collapsed_z=COLLAPSED, p_indep=P_INDEP,
                                      phi_chi_moves=PHI_MOVES,
                                      phi_chi_sigma=PHI_SIGMA,
                                      phi_mala_steps=MALA_STEPS,
                                      phi_mala_step=MALA_STEP,
                                      hmc_steps=HMC_STEPS, hmc_eps=HMC_EPS,
                                      hmc_inv_mass=hmc_inv_mass)
                w = st.Z[probe_obs] @ st.nu \
                    + jnp.einsum("nk,kpm,nm->np", st.Z[probe_obs], st.Phi,
                                 st.chi[probe_obs], precision="highest")
                probes = jnp.einsum("ntp,np->nt", B_probe, w,
                                    precision="highest").ravel()
                ll = log_likelihood(st, data)
                return st, jnp.concatenate([probes, ll[None]])
            return jax.lax.scan(body, st, jax.random.split(k, n))
        return jax.jit(jax.vmap(kept_chain))

    t0 = time.time()
    compiled = make_kept(CHUNK).lower(chain_keys, states).compile()
    rem_f = (make_kept(KEPT % CHUNK).lower(chain_keys, states).compile()
             if KEPT % CHUNK else None)
    compile_s = time.time() - t0

    windows = []
    for r in range(REPEATS):
        t0 = time.time()
        chunks, done, ci = [], 0, 0
        while done < KEPT:
            n = min(CHUNK, KEPT - done)
            f = compiled if n == CHUNK else rem_f
            kkeys = jax.vmap(lambda k: jax.random.fold_in(
                k, 777 + 1000 * r + ci))(chain_keys)
            states, out = f(kkeys, states)
            jax.block_until_ready(out)
            chunks.append(out)
            done += n
            ci += 1
        elapsed = time.time() - t0
        out = np.concatenate([np.asarray(o) for o in chunks], axis=1)
        # thin the DIAGNOSTIC series to <=20k points per chain: the FFT
        # autocovariances cost O(chains*probes*KEPT log KEPT) host-side
        # (tens of minutes at KEPT=1e5), and with tau >> step thinning
        # leaves the rank-normalized ESS/R-hat estimates unchanged
        step = max(1, KEPT // 20000)
        out = out[:, ::step, :]
        n_q = out.shape[2]
        ess_q = [rank_normalized_ess(out[:, :, j]) for j in range(n_q)]
        rhat_q = [rank_normalized_rhat(out[:, :, j]) for j in range(n_q)]
        ess_total = float(np.median(ess_q))
        windows.append({
            "ess": ess_total,
            "ess_per_sec": ess_total / elapsed,
            "elapsed_s": elapsed,
            "rhat_median": float(np.median(rhat_q)),
            "rhat_max": float(np.max(rhat_q)),
            "rhat_loglik": float(rhat_q[-1]),
            "iters_per_sec": N_CHAINS * KEPT / elapsed,
        })
        last_out = out

    vals = sorted(w["ess_per_sec"] for w in windows)
    med_w = sorted(windows, key=lambda w: w["ess_per_sec"])[len(windows) // 2]
    ess_per_sec = med_w["ess_per_sec"]
    elapsed = med_w["elapsed_s"]
    ess_total = med_w["ess"]

    within = [float(np.median([rank_normalized_ess(last_out[ci, :, j][None])
                               for j in range(last_out.shape[2])]))
              for ci in range(0, N_CHAINS, max(1, N_CHAINS // 8))]
    within_per_iter = float(np.mean(within)) / KEPT

    # ---- utilization from analytic per-sweep FLOPs ----
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    try:
        from flops import sweep_flops
        from utilization import cost_stats
        per_sweep = sweep_flops(N, int(data.L), P, K, M,
                                identity_basis=False, gauge=GAUGE,
                                collapsed_z=COLLAPSED)["total"]
        total_flops = per_sweep * N_CHAINS * KEPT
        util = cost_stats(compiled, elapsed, flops=total_flops,
                          source="analytic_per_sweep_x_trip_count")
        util["flops_per_sweep"] = per_sweep
    except Exception as e:
        util = {"error": str(e)}

    # ---- CPU single-thread baseline (measured, REPEATS runs) ----
    from numpy_baseline import NumpyGibbs
    hp_np = dict(a_Z_PM=hp.a_Z_PM, alpha_nu=hp.alpha_nu, beta_nu=hp.beta_nu,
                 alpha_0=hp.alpha_0, beta_0=hp.beta_0, nu_1=hp.nu_1)
    base = NumpyGibbs(np.asarray(data.y), np.asarray(data.mask),
                      np.asarray(data.B), np.asarray(data.pen), K, M, hp_np)
    sp = spectral_init(data, K, M)
    s = base.init_state()
    for name in ("Z", "nu", "chi", "Phi"):
        s[name] = np.asarray(sp[name], dtype=np.float64)
    s["sigma2"] = float(sp["sigma2"])
    base.sweep(s)
    n_base = 30
    base_rates = []
    for _ in range(REPEATS):
        t0 = time.time()
        for _ in range(n_base):
            base.sweep(s)
        base_rates.append(n_base / (time.time() - t0))
    base_iters_per_sec = float(np.median(base_rates))
    # vs_baseline credits the baseline with the device sampler's OWN
    # measured per-chain ESS/iter — conservative: the device kernels (joint
    # blocked draws, gauge moves) mix at least as well per sweep.
    base_ess_per_sec = within_per_iter * base_iters_per_sec

    result = {
        "metric": f"ess_per_sec_functional_K3_P8_N100_{N_CHAINS}chains",
        "value": round(ess_per_sec, 2),
        "unit": "ESS/s",
        "vs_baseline": round(ess_per_sec / base_ess_per_sec, 2),
        "detail": {
            "device": device,
            "card": card,
            "protocol": {"warmup": WARMUP, "anneal": ANNEAL, "kept": KEPT,
                         "gauge_moves": GAUGE, "collapsed_z": COLLAPSED,
                         "p_indep": P_INDEP, "repeats": REPEATS,
                         "warm_mode": warm_mode},
            "rhat_median": round(med_w["rhat_median"], 4),
            "rhat_max": round(med_w["rhat_max"], 4),
            "rhat_loglik": round(med_w["rhat_loglik"], 4),
            "ess_multichain_median_probe": round(ess_total, 1),
            "ess_within_chain_per_iter": round(within_per_iter, 4),
            "chain_sweeps_per_sec": round(med_w["iters_per_sec"], 1),
            "baseline_iters_per_sec": round(base_iters_per_sec, 2),
            "baseline_iters_per_sec_all": [round(r, 2) for r in base_rates],
            "ess_per_sec_spread": [round(vals[0], 2), round(vals[-1], 2)],
            "ess_per_sec_all": [round(w["ess_per_sec"], 2) for w in windows],
            "rhat_max_all": [round(w["rhat_max"], 4) for w in windows],
            # total ESS harvested this run / total wall time incl. warmup
            # (warm mode: warmup cost = the checkpoint load time)
            "ess_per_sec_incl_warmup": round(
                sum(w["ess"] for w in windows)
                / (warm_s + sum(w["elapsed_s"] for w in windows)), 2),
            "warmup_s": round(warm_s, 1),
            "compile_s": round(compile_s, 1),
            "timed_s": round(elapsed, 2),
            "utilization": util,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
