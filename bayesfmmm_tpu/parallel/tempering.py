"""Parallel tempering (replica exchange) — the multi-device replacement for
serial tempered transitions.

The reference's tempered-transition ladder runs 2*N_t rungs sequentially
inside one chain (BFMMM.h:780-865).  The idiomatic device-parallel equivalent
(SURVEY.md §2.2) is replica exchange: R replicas at a geometric temperature
ladder each run the *same* tempered Gibbs sweep concurrently (one vmapped
batch, sharded over the mesh `chains` axis), and adjacent replicas
periodically propose state swaps with probability

    min(1, exp((beta_i - beta_j) * (E_j - E_i))),   E = data log-likelihood

— the standard replica-exchange acceptance, which for the likelihood-only
tempering used by the reference (UpdateNu.h:134-136 etc.) needs only each
replica's log-likelihood.  Swaps are expressed as a permutation of the
replica axis; when replicas shard across devices XLA lowers the permutation
to a `collective-permute` on ICI (the `ppermute` design of SURVEY.md §5).
Cold chain (replica 0, beta=1) draws are the posterior samples.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bayesfmmm_tpu.ops import gibbs


def geometric_ladder(n_replicas: int, beta_min: float) -> jnp.ndarray:
    """[1, ..., beta_min] geometric — replica 0 is the cold chain."""
    if n_replicas == 1:
        return jnp.ones((1,))
    i = jnp.arange(n_replicas)
    return beta_min ** (i / (n_replicas - 1))


def auto_ladder(sd_E: float, beta_min: float, *, target_accept=0.4,
                max_replicas=64):
    """Size a PT ladder from a measured energy sd (round-4 VERDICT #4).

    For likelihood-only tempering the swap log-acceptance of an adjacent
    pair is dbeta * (E_j - E_i); with E fluctuations of scale sd(E) per
    replica, mean acceptance ~ 2*Phi(-dbeta*sd(E)) under the Gaussian
    approximation (Predescu et al. 2004), so hitting ``target_accept``
    needs  dbeta = z / sd(E),  z = -Phi^{-1}(target/2).  The reference
    hard-codes a geometric ladder with NO such check (BFMMM.h:661-670);
    the round-4 measurement (benchmarks/pt_operating_point.py) showed that
    at n = 1e4 observations the practical dbeta ~ n^{-1/2} ~ 0.01, so the
    default 8-replica ladder to beta=0.3 had swap_rate exactly 0.0 —
    silent 8x cost for zero benefit (BENCH_SUITE.md round-4 §4.1).

    Returns (ladder ndarray [1 ... >= beta_min], feasible flag).  When the
    needed rung count exceeds ``max_replicas`` the ladder is clamped to
    max_replicas rungs spanning only the reachable beta range and
    ``feasible`` is False — the caller should surface that PT cannot
    bridge to ``beta_min`` at a useful cost on this posterior.
    """
    from jax.scipy.special import ndtri
    z = float(-ndtri(target_accept / 2.0))
    dbeta = z / max(float(sd_E), 1e-12)
    n_needed = int(-(-(1.0 - beta_min) // dbeta)) + 1
    feasible = n_needed <= max_replicas
    n = min(n_needed, max_replicas)
    lo = beta_min if feasible else 1.0 - (n - 1) * dbeta
    return jnp.linspace(1.0, lo, n), feasible


def _loglik_portion(state, data):
    """E(state): the tempered factor (calculatePZeta:46-47 at beta=1)."""
    from bayesfmmm_tpu.ops.mean import effective_coeffs, rss_from_coeffs
    rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
    n = jnp.sum(data.mask)
    return -0.5 * n * jnp.log(state.sigma2) - rss / (2.0 * state.sigma2)


class PTState(NamedTuple):
    states: object          # replica-stacked GibbsState pytree
    swap_accepts: jnp.ndarray
    swap_attempts: jnp.ndarray


def pt_init(states):
    return PTState(states, jnp.zeros(()), jnp.zeros(()))


def pt_step(key, pt: PTState, data, hp, c, ladder, *, parity,
            covariate_mean=False, covariate_cov=False,
            n_sweeps_between=1, collapsed_z=False, gauge=False):
    """One PT round: tempered sweeps on every replica + one swap phase.

    parity: 0 swaps pairs (0,1),(2,3),...; 1 swaps (1,2),(3,4),... —
    alternate between calls for full ladder connectivity.

    collapsed_z/gauge select the production kernels for every replica's
    sweep (ops/gibbs.py update_z_chi / update_gauge).  Both are valid at
    any temperature: the collapsed kernel's chi-marginal uses the tempered
    effective variance sigma2/beta, and the gauge moves touch no
    likelihood factor at all.
    """
    R = ladder.shape[0]
    k_sweep, k_swap = jax.random.split(key)

    def replica_sweeps(k, st, beta):
        def body(s, kk):
            return gibbs.sweep_full(kk, s, data, hp, c,
                                    covariate_mean=covariate_mean,
                                    covariate_cov=covariate_cov,
                                    beta=beta, collapsed_z=collapsed_z,
                                    gauge=gauge), None
        ks = jax.random.split(k, n_sweeps_between)
        st, _ = jax.lax.scan(body, st, ks)
        return st

    sweep_keys = jax.random.split(k_sweep, R)
    states = jax.vmap(replica_sweeps)(sweep_keys, pt.states, ladder)

    # --- swap phase ---
    E = jax.vmap(lambda s: _loglik_portion(s, data))(states)     # (R,)
    idx = jnp.arange(R)
    partner = jnp.where((idx - parity) % 2 == 0,
                        jnp.clip(idx + 1, 0, R - 1),
                        jnp.clip(idx - 1, 0, R - 1))
    # pairs at the ladder edge point to themselves -> no-op
    valid = partner != idx
    log_acc = (ladder - ladder[partner]) * (E[partner] - E)
    u = jax.random.uniform(k_swap, (R,))
    # both members of a pair must use the same uniform: take the lower index's
    pair_lo = jnp.minimum(idx, partner)
    accept = (jnp.log(u[pair_lo]) < log_acc) & valid
    # a swap happens iff both directions agree (they compute the same
    # quantity, so accept is symmetric by construction)
    perm = jnp.where(accept, partner, idx)
    states = jax.tree.map(lambda x: x[perm], states)

    n_pairs = jnp.sum(valid.astype(jnp.float32)) / 2.0
    n_acc = jnp.sum((accept & (idx < partner)).astype(jnp.float32))
    return PTState(states, pt.swap_accepts + n_acc,
                   pt.swap_attempts + n_pairs)


def run_parallel_tempering(key, init_states, data, hp, c, *, n_rounds,
                           beta_min=0.3, n_sweeps_between=1,
                           covariate_mean=False, covariate_cov=False,
                           collapsed_z=False, gauge=False, ladder=None):
    """Run PT; returns (cold-chain trace dict, PTState, swap rate).

    init_states: replica-stacked GibbsState (leading axis R).  ``ladder``
    overrides the default geometric spacing (e.g. an `auto_ladder` result);
    its length must match R.
    """
    R = jax.tree.leaves(init_states)[0].shape[0]
    if ladder is None:
        ladder = geometric_ladder(R, beta_min)
    ladder = jnp.asarray(ladder).astype(data.y.dtype)
    if ladder.shape[0] != R:
        raise ValueError(f"ladder length {ladder.shape[0]} != replica "
                         f"count {R}")
    pt = pt_init(init_states)

    def round_fn(carry, inp):
        pt, = carry
        i, k = inp
        pt = pt_step(k, pt, data, hp, c, ladder, parity=i % 2,
                     covariate_mean=covariate_mean,
                     covariate_cov=covariate_cov,
                     n_sweeps_between=n_sweeps_between,
                     collapsed_z=collapsed_z, gauge=gauge)
        cold = jax.tree.map(lambda x: x[0], pt.states)
        return (pt,), cold

    keys = jax.random.split(key, n_rounds)
    (pt,), cold_trace = jax.lax.scan(
        round_fn, (pt,), (jnp.arange(n_rounds), keys))
    rate = pt.swap_accepts / jnp.maximum(pt.swap_attempts, 1.0)
    return cold_trace, pt, rate
