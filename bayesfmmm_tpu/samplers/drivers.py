"""MCMC drivers: the three-phase fitting pipeline, scan-based and chain-parallel.

Replacement of the reference L3 driver layer (BFMMM.h): instead
of a Python/C++ iteration loop mutating trace cubes, each phase is ONE jitted
``lax.scan`` whose carry is (state, rng) and whose stacked outputs are the
thinned traces.  Multiple restarts ("n_try", UserFunctions.cpp:302-325) and
production chains run as a vmapped batch — the chains axis is the natural
data-parallel shard axis on a device mesh (see parallel/mesh.py).

Tempered transitions (BFMMM.h:1556-1669) are implemented as a scan over the
2*N_t ladder rungs inside the iteration body, with the excursion accepted or
rejected wholesale via CalculateTTAcceptance.h:65-97 semantics.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bayesfmmm_tpu.models.likelihood import log_likelihood
from bayesfmmm_tpu.ops import gibbs


class TraceResult(NamedTuple):
    traces: dict          # parameter name -> (n_saved, ...) stacked draws
    loglik: jnp.ndarray   # (n_saved,)
    final_state: object


_TRACE_FIELDS = ("Z", "pi", "alpha3", "nu", "tau", "sigma2", "chi", "Phi",
                 "gamma", "delta", "A", "eta", "tau_eta", "xi", "gamma_xi",
                 "delta_xi", "A_xi")


def _collect(state):
    return {f: getattr(state, f) for f in _TRACE_FIELDS}


def make_temperature_ladder(beta_N_t: float, N_t: int) -> jnp.ndarray:
    """Geometric temperature ladder, reference-exact (BFMMM.h:661-670).

    The reference builds ones(N_t), pre-sets the last entry to beta_N_t,
    then overwrites entries 1..N_t-1 with cumulative powers of
    g = beta_N_t^(1/N_t) — so the ladder actually used is
    [1, g, g^2, ..., g^(N_t-1)] for N_t > 1, and [beta_N_t] for N_t == 1
    (only then does the pre-set survive).  The excursion's temp_ind walks
    0..N_t-1..0 over this array; the first/last rung sweeps therefore run
    at beta = 1 (untempered) for N_t > 1, exactly as the reference does.
    """
    if N_t == 1:
        return jnp.asarray([beta_N_t], dtype=jnp.float32)
    g = beta_N_t ** (1.0 / N_t)
    return g ** jnp.arange(N_t, dtype=jnp.float32)


def tempered_excursion(key, state, data, hp, c, ladder, *, covariate_mean,
                       covariate_cov, sweep_fn=None):
    """One tempered-transition excursion, accepted/rejected wholesale.

    Reference: BFMMM.h:1556-1669.  2*N_t tempered sweeps run at ladder
    temperatures walking 0..N_t-1..0 (BFMMM.h:1623-1629); one MH decision
    accepts the entire excursion with log-probability
    (CalculateTTAcceptance.h:65-97):

        logA = sum_{i=0}^{N_t-2} [ pz(S_i, b_{i+1}) - pz(S_i, b_i)
                                   - pz(S_{2N_t-i}, b_{i+1}) + pz(S_{2N_t-i}, b_i) ]

    where S_l is the state after l rung-sweeps and
    pz(S, b) = -b/2 * (n log sigma2 + rss/sigma2)  (calculatePZeta:46-47).
    pz is linear in b, so each state contributes (delta-beta) * pz_unit(S).
    """
    N_t = ladder.shape[0]
    sweep = sweep_fn or functools.partial(
        gibbs.sweep_full, covariate_mean=covariate_mean,
        covariate_cov=covariate_cov)

    def pz_unit(st):
        from bayesfmmm_tpu.ops.mean import effective_coeffs, rss_from_coeffs
        rss = rss_from_coeffs(data, effective_coeffs(st, data.X))
        n = jnp.sum(data.mask)
        return -0.5 * n * jnp.log(st.sigma2) - rss / (2.0 * st.sigma2)

    def weight_for_state(s):
        """Delta-beta multiplying pz_unit of state index s (0..2N_t)."""
        i_up = s                      # valid when s <= N_t-2
        i_dn = 2 * N_t - s            # valid when s >= N_t+2
        i = jnp.clip(jnp.where(s <= N_t - 2, i_up, i_dn), 0, N_t - 2)
        dbeta = ladder[i + 1] - ladder[i] if N_t > 1 else jnp.asarray(0.0)
        up = (s <= N_t - 2)
        dn = (s >= N_t + 2)
        return jnp.where(up, dbeta, jnp.where(dn, -dbeta, 0.0))

    def rung(carry, l):
        st, acc, k = carry
        temp_ind = jnp.where(l <= N_t, l - 1, 2 * N_t - l)
        beta_i = ladder[temp_ind]
        k, ks = jax.random.split(k)
        acc = acc + weight_for_state(l - 1) * pz_unit(st)
        st = sweep(ks, st, data, hp, c, beta=beta_i)
        return (st, acc, k), None

    (state_end, logA, key), _ = jax.lax.scan(
        rung, (state, jnp.asarray(0.0, jnp.float32), key),
        jnp.arange(1, 2 * N_t + 1))
    logA = logA + weight_for_state(jnp.asarray(2 * N_t)) * pz_unit(state_end)
    ku = jax.random.fold_in(key, 7919)
    logu = jnp.log(jax.random.uniform(ku))
    accept = logu < logA
    new_state = jax.tree.map(
        lambda a, b: jnp.where(accept, a, b), state_end, state)
    return new_state, accept, logA


def run_chain(key, state, data, hp, c, *, sweep, n_iters, thin=1,
              n_temp_trans=0, ladder=None, covariate_mean=False,
              covariate_cov=False):
    """Scan `n_iters` sweeps, stacking every `thin`-th draw.

    Replaces the reference's ring-buffer + batch-save loop (BFMMM.h:205-271):
    the trace lives in device memory as a stacked scan output and is
    offloaded by the caller.
    """
    use_tt = n_temp_trans and ladder is not None

    def one_iter(carry, i):
        st, k = carry
        k, ks = jax.random.split(k)
        if use_tt:
            def do_tt(st):
                s2, _, _ = tempered_excursion(
                    ks, st, data, hp, c, ladder,
                    covariate_mean=covariate_mean,
                    covariate_cov=covariate_cov, sweep_fn=sweep)
                return s2

            def do_sweep(st):
                return sweep(ks, st, data, hp, c)

            st = jax.lax.cond(
                (i > 0) & (jnp.mod(i, n_temp_trans) == 0), do_tt, do_sweep, st)
        else:
            st = sweep(ks, st, data, hp, c)
        ll = log_likelihood(st, data)
        return (st, k), (None if thin > 1 else (_collect(st), ll))

    if thin <= 1:
        (state, _), (traces, loglik) = jax.lax.scan(
            one_iter, (state, key), jnp.arange(n_iters))
        return TraceResult(traces, loglik, state)

    # thinned: inner scan of `thin` sweeps per saved draw
    n_saved = n_iters // thin

    def outer(carry, j):
        st, k = carry
        (st, k), _ = jax.lax.scan(
            one_iter, (st, k), j * thin + jnp.arange(thin))
        ll = log_likelihood(st, data)
        return (st, k), (_collect(st), ll)

    (state, _), (traces, loglik) = jax.lax.scan(
        outer, (state, key), jnp.arange(n_saved))
    return TraceResult(traces, loglik, state)


# ---------------------------------------------------------------------------
# Phase drivers
# ---------------------------------------------------------------------------

def phase_nu_z(key, state, data, hp, c, *, n_iters, covariate_mean=False):
    """Phase 1 (BFMMM_Nu_Z, BFMMM.h:989-1155): find mean/allocation structure.

    Phi is pinned at zero so the likelihood is chi-free (BFMMM.h:1063).
    """
    state = state.replace(Phi=jnp.zeros_like(state.Phi),
                          xi=jnp.zeros_like(state.xi))
    sweep = functools.partial(gibbs.sweep_nu_z, covariate_mean=covariate_mean)

    def sweep_adapter(k, st, d, h, cvec, beta=1.0):
        return sweep(k, st, d, h, cvec, beta=beta)

    return run_chain(key, state, data, hp, c, sweep=sweep_adapter,
                     n_iters=n_iters)


def phase_theta(key, state, data, hp, c, *, n_iters, covariate_mean=False,
                covariate_cov=False):
    """Phase 2 (BFMMM_Theta, BFMMM.h:1157-1345): covariance structure given
    pinned (Z, nu[, eta]) point estimates."""
    def sweep_adapter(k, st, d, h, cvec, beta=1.0):
        return gibbs.sweep_theta(k, st, d, h, covariate_mean=covariate_mean,
                                 covariate_cov=covariate_cov, beta=beta)

    return run_chain(key, state, data, hp, c, sweep=sweep_adapter,
                     n_iters=n_iters)


def phase_warm_start(key, state, data, hp, c, *, n_iters, thin=1,
                     n_temp_trans=0, beta_N_t=1.0, N_t=1,
                     covariate_mean=False, covariate_cov=False,
                     collapsed_z=False, gauge=False):
    """Phase 3 (BFMMM_MTT_warm_start, BFMMM.h:1346-1762): production sampler
    with optional tempered-transition excursions every n_temp_trans iters.

    collapsed_z/gauge select the production kernels (ops/gibbs.py
    update_z_chi / update_gauge — same posterior, Geweke-proven, better
    mixing); defaults keep the reference kernel census exactly."""
    sweep = functools.partial(gibbs.sweep_full, covariate_mean=covariate_mean,
                              covariate_cov=covariate_cov,
                              collapsed_z=collapsed_z, gauge=gauge)
    ladder = make_temperature_ladder(beta_N_t, N_t) if n_temp_trans else None
    return run_chain(key, state, data, hp, c, sweep=sweep, n_iters=n_iters,
                     thin=thin, n_temp_trans=n_temp_trans, ladder=ladder,
                     covariate_mean=covariate_mean,
                     covariate_cov=covariate_cov)


def posterior_median_state(traces, burnin_prop=0.8):
    """Per-element posterior medians of post-burn-in draws, with Z rows and
    pi re-normalized to the simplex (UserFunctions.cpp:1557-1650)."""
    def med(x):
        n = x.shape[0]
        start = int(burnin_prop * n)
        return jnp.median(x[start:], axis=0)

    est = {k: med(v) for k, v in traces.items()}
    est["Z"] = est["Z"] / jnp.sum(est["Z"], axis=-1, keepdims=True)
    est["pi"] = est["pi"] / jnp.sum(est["pi"])
    return est


def best_chain(loglik_batch, window=100):
    """Restart selection: argmax of mean loglik over the last `window` draws
    (UserFunctions.cpp:308-325)."""
    tail = loglik_batch[:, -window:]
    return jnp.argmax(jnp.mean(tail, axis=1))
