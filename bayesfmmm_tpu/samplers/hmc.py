"""Gradient-based whole-model sampler: jittered HMC with adaptation.

The gradient-based primary path (SURVEY.md §7 / BASELINE.json north star):
whole-model leapfrog on the unconstrained log-joint (models/logjoint.py),
vmapped over chains.  Fixed-length trajectories with uniform length jitter
(the ChEES-style compromise: no data-dependent tree recursion, so XLA gets
a single static-shape program — unlike NUTS whose U-turn recursion defeats
static pipelining; cf. PAPERS.md ChEES/SMC references).

Warmup: dual-averaging step size (Nesterov/Hoffman-Gelman schedule, target
acceptance 0.8) + Welford diagonal mass estimation, two phases:
phase 1 adapts eps under identity mass, phase 2 freezes the estimated mass
and re-adapts eps.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


class HMCState(NamedTuple):
    position: jnp.ndarray      # flat
    logp: jnp.ndarray
    grad: jnp.ndarray


class AdaptState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_avg: jnp.ndarray
    step: jnp.ndarray
    mean: jnp.ndarray          # Welford
    m2: jnp.ndarray
    count: jnp.ndarray


def _leapfrog(grad_fn, q, p, grad, eps, inv_mass, n_steps):
    def body(_, carry):
        q, p, grad = carry
        p = p + 0.5 * eps * grad
        q = q + eps * inv_mass * p
        logp, grad = grad_fn(q)
        p = p + 0.5 * eps * grad
        return q, p, grad

    q, p, grad = jax.lax.fori_loop(0, n_steps, body, (q, p, grad))
    return q, p, grad


def hmc_kernel(log_joint_flat):
    """Returns step(key, state, eps, inv_mass, n_steps) -> (state, accept_p)."""
    vg = jax.value_and_grad(log_joint_flat)

    def grad_fn(q):
        return vg(q)

    def step(key, state: HMCState, eps, inv_mass, n_steps):
        kp, ka, kj = jax.random.split(key, 3)
        p0 = jax.random.normal(kp, state.position.shape,
                               state.position.dtype) / jnp.sqrt(inv_mass)
        # jitter trajectory length in [1, n_steps]
        n = jax.random.randint(kj, (), 1, n_steps + 1)
        q, p, grad = _leapfrog(lambda q: vg(q), state.position, p0,
                               state.grad, eps, inv_mass, n)
        logp_new = None
        logp_new, grad = vg(q)
        ke0 = 0.5 * jnp.sum(inv_mass * p0 * p0)
        ke1 = 0.5 * jnp.sum(inv_mass * p * p)
        log_acc = (logp_new - ke1) - (state.logp - ke0)
        log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
        accept = jnp.log(jax.random.uniform(ka)) < log_acc
        new = HMCState(
            position=jnp.where(accept, q, state.position),
            logp=jnp.where(accept, logp_new, state.logp),
            grad=jnp.where(accept, grad, state.grad))
        return new, jnp.minimum(1.0, jnp.exp(log_acc))

    return step


def _dual_avg_update(adapt: AdaptState, accept_p, target=0.8, t0=10.0,
                     gamma=0.05, kappa=0.75, mu=None):
    step = adapt.step + 1.0
    h = target - accept_p
    h_avg = (1.0 - 1.0 / (step + t0)) * adapt.h_avg + h / (step + t0)
    log_eps = (mu if mu is not None else 0.0) - jnp.sqrt(step) / gamma * h_avg
    w = step ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * adapt.log_eps_avg
    return adapt._replace(log_eps=log_eps, log_eps_avg=log_eps_avg,
                          h_avg=h_avg, step=step)


def run_hmc(key, log_joint, init_positions, *, n_warmup=500, n_samples=500,
            n_leapfrog=32, target_accept=0.8, init_step_size=0.01):
    """Run vmapped chains of jittered HMC.

    init_positions: a pytree batch (leading chains axis).
    Returns (positions_trace pytree (chains, n_samples, ...), diagnostics).
    """
    if n_warmup < 4:
        raise ValueError("'n_warmup' must be an integer >= 4 (two adaptation "
                         "phases need at least 2 steps each)")
    n_warm1 = n_warmup // 2
    n_warm2 = n_warmup - n_warm1
    flat0, unravel = ravel_pytree(
        jax.tree.map(lambda x: x[0], init_positions))
    n_chains = jax.tree.leaves(init_positions)[0].shape[0]

    def log_joint_flat(q):
        return log_joint(unravel(q))

    step = hmc_kernel(log_joint_flat)
    vg = jax.value_and_grad(log_joint_flat)
    dim = flat0.shape[0]

    def chain(key, init_flat):
        logp0, grad0 = vg(init_flat)
        st = HMCState(init_flat, logp0, grad0)
        mu = jnp.log(10.0 * init_step_size)
        ad = AdaptState(jnp.log(init_step_size), jnp.log(init_step_size),
                        0.0, 0.0, jnp.zeros(dim), jnp.zeros(dim), 0.0)
        inv_mass = jnp.ones(dim)

        def warm1(carry, k):
            st, ad = carry
            st, ap = step(k, st, jnp.exp(ad.log_eps), inv_mass, n_leapfrog)
            ad = _dual_avg_update(ad, ap, target_accept, mu=mu)
            # Welford on the second half
            upd = ad.step > n_warmup // 4
            delta = st.position - ad.mean
            cnt = ad.count + jnp.where(upd, 1.0, 0.0)
            mean = ad.mean + jnp.where(upd, delta / jnp.maximum(cnt, 1.0), 0.0)
            m2 = ad.m2 + jnp.where(upd, delta * (st.position - mean), 0.0)
            ad = ad._replace(mean=mean, m2=m2, count=cnt)
            return (st, ad), ap

        keys1 = jax.random.split(key, n_warm1)
        (st, ad), aps1 = jax.lax.scan(warm1, (st, ad), keys1)

        var = ad.m2 / jnp.maximum(ad.count - 1.0, 1.0)
        inv_mass2 = jnp.where(var > 1e-8, var, 1.0)

        ad2 = AdaptState(ad.log_eps_avg, ad.log_eps_avg, 0.0, 0.0,
                         jnp.zeros(dim), jnp.zeros(dim), 0.0)
        mu2 = ad.log_eps_avg + jnp.log(10.0)

        def warm2(carry, k):
            st, ad = carry
            st, ap = step(k, st, jnp.exp(ad.log_eps), inv_mass2, n_leapfrog)
            ad = _dual_avg_update(ad, ap, target_accept, mu=mu2)
            return (st, ad), ap

        keys2 = jax.random.split(jax.random.fold_in(key, 1), n_warm2)
        (st, ad2), aps2 = jax.lax.scan(warm2, (st, ad2), keys2)
        eps_final = jnp.exp(ad2.log_eps_avg)

        def sample(carry, k):
            st = carry
            st, ap = step(k, st, eps_final, inv_mass2, n_leapfrog)
            return st, (st.position, ap)

        keys3 = jax.random.split(jax.random.fold_in(key, 2), n_samples)
        st, (qs, aps) = jax.lax.scan(sample, st, keys3)
        return qs, {"accept_mean": aps.mean(), "eps": eps_final,
                    "warm_accept": aps2.mean()}

    keys = jax.random.split(key, n_chains)
    flats = jax.vmap(lambda tree_i: ravel_pytree(tree_i)[0],
                     in_axes=0)(init_positions) \
        if False else jnp.stack([
            ravel_pytree(jax.tree.map(lambda x: x[i], init_positions))[0]
            for i in range(n_chains)])
    qs, diag = jax.jit(jax.vmap(chain))(keys, flats)
    # unravel trace: (chains, samples, dim) -> pytree with those leading axes
    unc_trace = jax.vmap(jax.vmap(unravel))(qs)
    return unc_trace, diag
