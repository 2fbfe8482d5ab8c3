"""Smoke check of the production Gibbs path on an NVIDIA GPU.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the mesh path only

One process drives every phase, in order.  A failed phase prints its
traceback and the script goes on to the next; if any phase failed the
script exits 1 and prints no result.  Without a GPU it exits 2 before any
phase runs.  The last line of standard output, on success, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases (one GPU):
  device      the first JAX device must be a GPU; prints nvidia-smi's name
              and power limit and the device kind.
  cache       persistent compilation cache (utils/compile_cache.py).
  parity      kernels at real widths, float32 at precision "highest" on the
              card against float64 NumPy (tolerances in TOLERANCES).
  sweep       the headline fit (K=3, P=8, M=4, N=100, L=100, 256 chains)
              scanned from the simulation truth with the production
              kernels; chain-sweeps/s, compile time, memory analysis.
  api         api.fit_nu_z -> fit_theta -> fit_warm_start(production) at
              the headline widths, trace export and exact reload.
  covadj      a few sweeps of the covariate-adjusted covariance fit
              (K=2, P=8, M=16, N=80, D=1): the joint draw at dimension 256.
  gpu-tests   the pytest tests marked ``gpu``, run in this process.

Phases (--four-cards): the (chains, data) mesh at the headline widths on
meshes (4, 1) and (2, 2): a scanned sweep and a parallel-tempering round,
each against the same program on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (relative error bound, what is compared).  All device math is float32 at
# precision "highest"; references are float64 NumPy on the host.  Errors
# are max|x - ref| / max|ref| per output.  TF32 (about 3 decimal digits)
# would fail every one of these bounds.
TOLERANCES = {
    # joint precision draw: Cholesky + blocked substitution, condition
    # number of A <= 1e3, so float32 backward error ~ 1e3 * 6e-8 * sqrt(D)
    "precision_draw_pair": 2e-4,
    # 4x4 unrolled Cholesky and substitutions, condition number <= 1e2
    "small_entries": 2e-5,
    # effective coefficients w (sums of K*(1+M) products)
    "effective_coeffs": 1e-5,
    # residual sum of squares: y - B w cancels ~1.5 digits at the truth
    "rss_from_coeffs": 1e-4,
    "log_likelihood": 1e-5,
}
HEADLINE = dict(K=3, P=8, M=4, N=100, n_time=(100, 100), seed=7)
COVADJ = dict(K=2, P=8, M=16, N=80, D=1, n_time=(100, 100), seed=7)


class SmokeFailure(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _rel_err(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    _check(x.shape == ref.shape, f"shape {x.shape} != reference {ref.shape}")
    _check(np.all(np.isfinite(x)), "non-finite values")
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _within(name, errs):
    bound = TOLERANCES[name]
    worst = max(errs.values())
    _check(worst <= bound, f"{name}: {errs} exceeds {bound}")
    return {"max_rel_err": worst, "bound": bound, **errs}


# ---------------------------------------------------------------- device --

def gpu_identity():
    """nvidia-smi's 'name, power.limit' line for every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def check_device(count=1):
    """Exit with code 2 unless JAX's first device is a GPU and ``count``
    devices are visible.  Returns the device summary for the last line."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r}); this check runs only on a GPU",
              file=sys.stderr)
        raise SystemExit(2)
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(devs)}",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------- parity --

def _spd_batch(rng, batch, D, cond):
    """SPD (batch, D, D) float64 with eigenvalues log-spaced in [1, cond]."""
    q, _ = np.linalg.qr(rng.normal(size=(batch, D, D)))
    lam = np.logspace(0.0, np.log10(cond), D)
    return np.einsum("bij,j,bkj->bik", q, lam, q)


def parity_precision_draw(n_chains, D, seed=0, cond=1e3):
    """vmapped linalg.precision_draw_pair vs float64 NumPy."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla

    from bayesfmmm_tpu.ops import linalg

    rng = np.random.default_rng(seed)
    A = _spd_batch(rng, n_chains, D, cond)
    b = rng.normal(size=(n_chains, D)) * 10.0
    z = rng.normal(size=(n_chains, D))
    f = jax.jit(jax.vmap(linalg.precision_draw_pair))
    mean, noise = f(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
                    jnp.asarray(z, jnp.float32))
    L = np.linalg.cholesky(A)
    mean_ref = np.linalg.solve(A, b[..., None])[..., 0]
    noise_ref = np.stack([sla.solve_triangular(L[i].T, z[i], lower=False)
                          for i in range(n_chains)])
    return _within("precision_draw_pair",
                   {"mean": _rel_err(mean, mean_ref),
                    "noise": _rel_err(noise, noise_ref)})


def parity_small_entries(batch, M=4, seed=1, cond=1e2):
    """small_chol_entries -> small_solve_lower_entries ->
    small_solve_upper_t_entries at (batch,) vs float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.ops import linalg

    rng = np.random.default_rng(seed)
    A = _spd_batch(rng, batch, M, cond)
    b = rng.normal(size=(batch, M))

    def chain(A, b):
        a = [[A[:, i, j] for j in range(i + 1)] for i in range(M)]
        L = linalg.small_chol_entries(a)
        w = linalg.small_solve_lower_entries(L, [b[:, i] for i in range(M)])
        x = linalg.small_solve_upper_t_entries(L, w)
        Lm = jnp.stack([jnp.stack([L[i][j] if j <= i else jnp.zeros_like(
            L[0][0]) for j in range(M)], -1) for i in range(M)], -2)
        return Lm, jnp.stack(w, -1), jnp.stack(x, -1)

    Lm, w, x = jax.jit(chain)(jnp.asarray(A, jnp.float32),
                              jnp.asarray(b, jnp.float32))
    L_ref = np.linalg.cholesky(A)
    w_ref = np.linalg.solve(L_ref, b[..., None])[..., 0]
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    return _within("small_entries", {"chol": _rel_err(Lm, L_ref),
                                     "solve_lower": _rel_err(w, w_ref),
                                     "solve_upper_t": _rel_err(x, x_ref)})


def parity_mean_likelihood(data, state):
    """mean.effective_coeffs, mean.rss_from_coeffs and
    likelihood.log_likelihood vs float64 NumPy on one state."""
    import jax

    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.ops import mean

    f64 = lambda x: np.asarray(x, np.float64)
    Z, nu, Phi, chi = f64(state.Z), f64(state.nu), f64(state.Phi), \
        f64(state.chi)
    B, y, mask = f64(data.B), f64(data.y), f64(data.mask)
    w_ref = Z @ nu + np.einsum("nk,kpm,nm->np", Z, Phi, chi)
    rss_ref = np.sum((y - np.einsum("nlp,np->nl", B, w_ref)) ** 2)
    s2 = float(state.sigma2)
    ll_ref = (-0.5 * mask.sum() * (np.log(2 * np.pi) + np.log(s2))
              - 0.5 * rss_ref / s2)

    w = jax.jit(mean.effective_coeffs)(state, data.X)
    rss = jax.jit(mean.rss_from_coeffs)(data, w)
    ll = jax.jit(log_likelihood)(state, data)
    out = {}
    out.update(_within("effective_coeffs", {"w": _rel_err(w, w_ref)}))
    out["rss"] = _within("rss_from_coeffs", {"rss": _rel_err(rss, rss_ref)})
    out["loglik"] = _within("log_likelihood",
                            {"loglik": _rel_err(ll, ll_ref)})
    return out


# ----------------------------------------------------------------- sweep --

def _stack(state, n):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda x: jnp.broadcast_to(
        jnp.asarray(x), (n,) + np.shape(x)), state)


def make_sweep_scan(data, hp, c, n_sweeps, **sweep_kw):
    """jit(vmap over chains of a lax.scan of n_sweeps gibbs.sweep_full)."""
    import jax

    from bayesfmmm_tpu.ops import gibbs

    def chain(k, st):
        def body(s, kk):
            return gibbs.sweep_full(kk, s, data, hp, c, **sweep_kw), None
        st, _ = jax.lax.scan(body, st, jax.random.split(k, n_sweeps))
        return st
    return jax.jit(jax.vmap(chain))


def _mem(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def run_headline_sweep(n_chains=256, n_sweeps=200, cfg=HEADLINE,
                       loglik_bound=None):
    """Scanned production sweeps from the simulation truth: compile once,
    run n_sweeps twice (the second call is the timed window), check
    finiteness and the loglik against the truth."""
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.config import Priors
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    data, truth = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        n_time=cfg["n_time"])
    truth = jax.tree.map(jnp.asarray, truth)
    hp = Priors()
    c = jnp.full((cfg["K"],), 10.0)
    run = make_sweep_scan(data, hp, c, n_sweeps, collapsed_z=True,
                          gauge=True)
    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    states = _stack(truth, n_chains)

    t0 = time.perf_counter()
    compiled = run.lower(keys, states).compile()
    compile_s = time.perf_counter() - t0
    states = compiled(keys, states)
    jax.block_until_ready(states)
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    t0 = time.perf_counter()
    states = compiled(keys, states)
    jax.block_until_ready(states)
    window_s = time.perf_counter() - t0

    for leaf in jax.tree.leaves(states):
        _check(bool(jnp.all(jnp.isfinite(leaf))), "NaN/inf in final state")
    ll = np.asarray(jax.jit(jax.vmap(log_likelihood, in_axes=(0, None)))(
        states, data), np.float64)
    ll_truth = float(log_likelihood(truth, data))
    gap = float(ll.mean() - ll_truth)
    bound = loglik_bound if loglik_bound is not None else _loglik_bound(cfg)
    _check(abs(gap) <= bound,
           f"mean loglik {ll.mean():.2f} is {gap:.2f} from the truth's "
           f"{ll_truth:.2f} (bound {bound:.1f})")
    return {"chains": n_chains, "sweeps_per_window": n_sweeps,
            "chain_sweeps_per_s": n_chains * n_sweeps / window_s,
            "window_s": window_s, "compile_s": compile_s,
            "memory_analysis": _mem(compiled),
            "loglik_truth": ll_truth, "loglik_mean": float(ll.mean()),
            "loglik_sd": float(ll.std()), "loglik_gap": gap,
            "loglik_bound": bound}


def _loglik_bound(cfg):
    """Bound on |mean posterior loglik - loglik at the truth|.  For d free
    parameters, E_post[loglik] - loglik(truth) is about (chi2_d - d) / 2
    for the dataset at hand: zero-mean with sd sqrt(d / 2).  Allow two sd;
    a broken conditional or TF32-rounded mean moves it by hundreds."""
    K, P, M, N = cfg["K"], cfg["P"], cfg["M"], cfg["N"]
    d = N * (K - 1) + N * M + K * P + K * P * M
    return 2.0 * float(np.sqrt(0.5 * d))


# ------------------------------------------------------------------- api --

_STEMS = {"Nu": "nu", "Chi": "chi", "Pi": "pi", "alpha_3": "alpha3",
          "A": "A", "Delta": "delta", "Sigma": "sigma2", "Tau": "tau",
          "Gamma": "gamma", "Phi": "Phi", "Z": "Z"}


def run_api_pipeline(n_chains=256, iters=200, cfg=HEADLINE):
    """Public API at the given widths; traces exported and reloaded
    exactly through io.armaio."""
    from bayesfmmm_tpu import api
    from bayesfmmm_tpu.io import armaio
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    data, _ = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        n_time=cfg["n_time"])
    t0 = time.perf_counter()
    r1 = api.fit_nu_z(data=data, K=cfg["K"], M=cfg["M"],
                      tot_mcmc_iters=iters, n_try=1)
    r2 = api.fit_theta(r1, tot_mcmc_iters=iters, n_try=1)
    r3 = api.fit_warm_start(r1, r2, tot_mcmc_iters=iters,
                            kernels="production", n_chains=n_chains,
                            progress=False)
    fit_s = time.perf_counter() - t0
    ll = np.asarray(r3.loglik)
    _check(np.all(np.isfinite(ll)), "non-finite warm-start loglik")
    with tempfile.TemporaryDirectory() as d:
        api.export_traces(d, r3.traces, r3.config)
        back = armaio.load_trace_dir(d)
    for stem, key in _STEMS.items():
        want = np.asarray(r3.traces[key], np.float64)
        _check(stem in back, f"trace {stem} missing after reload")
        got = back[stem].reshape(want.shape)
        _check(np.array_equal(got, want), f"trace {stem} not exact")
    return {"chains": n_chains, "iters": iters, "fit_s": fit_s,
            "loglik_phase1_mean": float(np.mean(r1.loglik[-20:])),
            "loglik_warm_mean": float(ll[-20:].mean()),
            "traces_exact": sorted(_STEMS)}


# ---------------------------------------------------------------- covadj --

def run_covadj(n_chains=16, n_sweeps=5, cfg=COVADJ):
    """Covariate-adjusted covariance sweeps (eta and xi): the joint xi
    draw has dimension K*M*D*P."""
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.models.state import init_state
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    data, _ = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        D=cfg["D"], with_eta=True, with_xi=True, n_time=cfg["n_time"])
    mc = ModelConfig(K=cfg["K"], P=cfg["P"], M=cfg["M"], D=cfg["D"],
                     covariate_mean=True, covariate_cov=True)
    c = jnp.full((cfg["K"],), 10.0)
    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    states = jax.jit(jax.vmap(lambda k: init_state(k, mc, data)))(keys)
    run = make_sweep_scan(data, Priors(), c, n_sweeps, covariate_mean=True,
                          covariate_cov=True)
    t0 = time.perf_counter()
    compiled = run.lower(keys, states).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    states = compiled(keys, states)
    jax.block_until_ready(states)
    run_s = time.perf_counter() - t0
    for leaf in jax.tree.leaves(states):
        _check(bool(jnp.all(jnp.isfinite(leaf))), "NaN/inf in final state")
    return {"chains": n_chains, "sweeps": n_sweeps,
            "joint_xi_dim": cfg["K"] * cfg["M"] * cfg["D"] * cfg["P"],
            "compile_s": compile_s, "run_s": run_s}


# ------------------------------------------------------------- gpu tests --

def run_gpu_tests():
    """pytest -m gpu in this process (a second process could not get the
    card's memory).  tests/conftest.py pins the CPU, so it is not loaded."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "--noconftest",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    _check(rc == 0, f"pytest -m gpu exited {int(rc)}")
    return {"pytest_rc": int(rc)}


# ------------------------------------------------------------ four cards --

def _chains_off(a, b, rtol, atol):
    """Number of chains (leading axis) in which any leaf of ``a`` differs
    from ``b`` by more than atol + rtol |b|."""
    import jax
    off = None
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        _check(np.all(np.isfinite(x)), "non-finite sharded output")
        bad = np.abs(x - y) > atol + rtol * np.abs(y)
        bad = bad.reshape(bad.shape[0], -1).any(axis=1)
        off = bad if off is None else off | bad
    return int(off.sum())


# Sharded vs one-card, same program: only summation order differs (the
# data axis splits each reduction over observations into a psum).  A chain
# whose values differ by more than FOUR_CARD_RTOL / FOUR_CARD_ATOL has had
# a last-bit difference flip a Metropolis-Hastings decision (the Z update,
# a PT swap); at most FOUR_CARD_MAX_OFF of the chains may do so, and the PT
# swap rate may move by at most FOUR_CARD_MAX_RATE_DIFF.
FOUR_CARD_RTOL, FOUR_CARD_ATOL = 1e-3, 1e-4
FOUR_CARD_MAX_OFF = 0.05
FOUR_CARD_MAX_RATE_DIFF = 0.01


def run_four_cards(n_chains=256, n_sweeps=3, pt_rounds=2,
                   meshes=((4, 1), (2, 2)), cfg=HEADLINE):
    """The (chains, data) mesh path against the same program on one card.

    For each mesh: a scanned sweep_full (reference kernels) and a
    parallel-tempering round over the sharded chain ensemble.  Outputs
    must be sharded over every device of the mesh (nothing left on device
    0) and equal the one-card run within the FOUR_CARD_* bounds."""
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.config import Priors
    from bayesfmmm_tpu.parallel import mesh as pmesh
    from bayesfmmm_tpu.parallel.tempering import run_parallel_tempering
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    data_host, truth = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        n_time=cfg["n_time"])
    hp = Priors()
    c = jnp.full((cfg["K"],), 10.0)
    keys0 = jax.random.split(jax.random.PRNGKey(0), n_chains)
    states0 = _stack(jax.tree.map(jnp.asarray, truth), n_chains)

    def run(d, keys, states):
        @jax.jit
        def pt(key, st):
            cold, ptst, rate = run_parallel_tempering(
                key, st, d, hp, c, n_rounds=pt_rounds, beta_min=0.5)
            return cold.sigma2, ptst.states, rate

        t0 = time.perf_counter()
        swept = make_sweep_scan(d, hp, c, n_sweeps)(keys, states)
        out = pt(jax.random.PRNGKey(7), swept)
        jax.block_until_ready((swept, out))
        return swept, out, time.perf_counter() - t0

    dev0 = jax.devices()[0]
    ref_sw, ref_pt, one_s = run(jax.device_put(data_host, dev0),
                                *jax.device_put((keys0, states0), dev0))
    print(f"[four-cards] one card done in {one_s:.1f}s", flush=True)
    res = {"n_chains": n_chains, "n_sweeps": n_sweeps,
           "pt_rounds": pt_rounds, "rtol": FOUR_CARD_RTOL,
           "atol": FOUR_CARD_ATOL, "max_chains_off": FOUR_CARD_MAX_OFF,
           "max_swap_rate_diff": FOUR_CARD_MAX_RATE_DIFF,
           "one_card_s_incl_compile": one_s,
           "swap_rate_one_card": float(ref_pt[2]), "meshes": {}}
    failures = []
    for n_chain_sh, n_data_sh in meshes:
        n_dev = n_chain_sh * n_data_sh
        devices = jax.devices()[:n_dev]
        mesh = pmesh.make_mesh(n_chain_shards=n_chain_sh,
                               n_data_shards=n_data_sh, devices=devices)
        sw, pto, mesh_s = run(
            pmesh.shard_data(data_host, mesh),
            jax.device_put(keys0, pmesh.key_sharding(mesh)),
            pmesh.shard_chain_states(states0, mesh))
        name = f"{n_chain_sh}x{n_data_sh}"
        print(f"[four-cards] mesh {name} done in {mesh_s:.1f}s", flush=True)
        for leaf in jax.tree.leaves((sw, pto[1])):
            if leaf.sharding.device_set != set(devices):
                failures.append(f"{name}: an output sits on "
                                f"{len(leaf.sharding.device_set)} of "
                                f"{n_dev} devices")
                break
        shard_chains = {s.data.shape[0] for s in sw.nu.addressable_shards}
        if shard_chains != {n_chains // n_chain_sh}:
            failures.append(f"{name}: chain shards {shard_chains}")
        sweep_off = _chains_off(sw, ref_sw, FOUR_CARD_RTOL, FOUR_CARD_ATOL)
        pt_off = _chains_off(pto[1], ref_pt[1], FOUR_CARD_RTOL,
                             FOUR_CARD_ATOL)
        sigma_off = _chains_off(pto[0].T, ref_pt[0].T, FOUR_CARD_RTOL,
                                FOUR_CARD_ATOL)
        rate_diff = abs(float(pto[2]) - float(ref_pt[2]))
        res["meshes"][name] = {
            "s_incl_compile": mesh_s, "sweep_chains_off": sweep_off,
            "pt_replicas_off": pt_off, "pt_cold_rounds_off": sigma_off,
            "swap_rate": float(pto[2])}
        limit = FOUR_CARD_MAX_OFF * n_chains
        if (sweep_off > limit or pt_off > limit or sigma_off
                or rate_diff > FOUR_CARD_MAX_RATE_DIFF):
            failures.append(f"{name}: differs from one card")
    _check(not failures,
           "; ".join(failures) + " " + json.dumps(res, default=float))
    return res


# ------------------------------------------------------------------ main --

def _phase(name, fn, failed):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:
        failed.append(name)
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
              flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        return None
    print(f"[{name}] ok {time.perf_counter() - t0:.1f}s "
          f"{json.dumps(res, default=float)}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path and its one-card "
                         "comparison")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    if args.four_cards:
        # A parity check, not a timing: skip XLA's GEMM autotuning, which
        # dominates compiling the three placements (must precede JAX's
        # backend start-up).
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()

    device = check_device(count)
    print(gpu_identity(), flush=True)
    print(f"device_kind: {device['kind']}  count: {device['count']}",
          flush=True)
    if args.four_cards:
        device["count"] = 4

    sys.path.insert(0, REPO)
    failed = []
    _phase("cache", lambda: {"dir": _enable_cache()}, failed)
    if args.four_cards:
        _phase("four-cards", run_four_cards, failed)
    else:
        _phase("parity-draw-96", lambda: parity_precision_draw(256, 96),
               failed)
        _phase("parity-draw-256", lambda: parity_precision_draw(16, 256),
               failed)
        _phase("parity-small-entries",
               lambda: parity_small_entries(256 * 100, 4), failed)
        _phase("parity-mean-likelihood", _parity_headline_state, failed)
        _phase("sweep", run_headline_sweep, failed)
        _phase("api", run_api_pipeline, failed)
        _phase("covadj", run_covadj, failed)
        _phase("gpu-tests", run_gpu_tests, failed)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


def _enable_cache():
    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    return enable_compile_cache()


def _parity_headline_state(cfg=HEADLINE):
    from bayesfmmm_tpu.utils.simulate import simulate_functional
    data, truth = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        n_time=cfg["n_time"])
    return parity_mean_likelihood(data, truth)


if __name__ == "__main__":
    sys.exit(main())
