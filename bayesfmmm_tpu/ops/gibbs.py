"""Conditional updaters (Gibbs/MH kernels) for the mixed membership model.

Vectorized re-derivation of the reference's L2 kernel layer
(inst/include/BayesFMMM/Update*.h, ~80 C++ functions).  Design differences:

  * Every updater is a pure function ``(key, state, ...) -> state`` — no
    mutable trace cubes; `lax.scan` stacks draws at the driver level.
  * The {plain, tempered} x {functional, MV, HD} x {covariate-adjusted}
    variant explosion collapses: temperature ``beta`` is an argument
    (beta=1 == untempered; the tempered C++ variants differ only by scaling
    the data-precision terms, e.g. UpdateNu.h:134-136, UpdateSigma.h:101-103),
    the family is carried by the data's basis/penalty matrices, and
    covariate terms vanish identically when D == 0.
  * Per-observation / per-feature C++ loops become batched einsums over
    precomputed Gram matrices (`data.G`), with sequential blocked draws kept
    only where the reference's Gibbs factorization requires them (rows of
    nu, slices of Phi, ...), implemented as `lax.fori_loop`.
  * **Gram space** (ops/mean.py module docstring): the sweep carries only
    the effective coefficients w_n (P-vector per observation) and the
    sufficient statistics u_n = B_n'y_n, G_n = B_n'B_n — no (N, L) tensor
    is formed inside the blocked loops, cutting HBM traffic by ~L/P.
    Squared residual norms (sigma2, MH quadratics) are the exception: they
    materialize the residual once per call for f32 stability (ops/mean.py).
    Block precisions depend only on (Z, chi, X, priors), never on
    the coefficients being redrawn, so every blocked kernel factorizes ALL
    its block precisions in ONE batched Cholesky upfront and keeps just
    O(N·P) dot products + triangular solves inside the sequential loop.

Masking: `data.B` rows and `data.y` entries are pre-zeroed at padded time
points, so u/G/yy absorb the mask; only observation *counts* consult
`data.mask`.

Cited reference lines document the exact conditional each kernel reproduces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from bayesfmmm_tpu.ops.distributions import (
    chol_precision,
    dirichlet_logpdf_unnormalized,
    log_multi_beta,
    mvn_from_chol,
    rdirichlet,
    truncnorm_logpdf,
    truncnorm_sample,
)
from bayesfmmm_tpu.ops.linalg import (
    mvn_from_precision_fused,
    small_chol,
    small_chol_entries,
    small_chol_logdet,
    small_logdet_entries,
    small_solve_lower,
    small_solve_lower_entries,
    small_solve_upper_t,
    small_solve_upper_t_entries,
)
from bayesfmmm_tpu.ops.mean import (
    SweepCache,
    build_cache,
    eigen_directions,
    feature_offsets,
    rss_from_coeffs,
)

_HI = dict(precision="highest")

# Unroll small sequential block loops for XLA fusion; large trip counts
# (e.g. the xi loop at K*M*D with M=KP) would explode compile time, so they
# roll (benchmarks/suite.py config 4 compiled in 161s fully unrolled).
_MAX_UNROLL = 16


def _unroll(n):
    return bool(n <= _MAX_UNROLL)


def _gram_bvec(data, wt, w_excl):
    """sum_n wt_n B_n'(y_n - B_n w_excl_n) = sum_n wt_n (u_n - G_n w_excl_n).

    The Gram-space form of every blocked kernel's linear term — O(N·P^2)
    with no L-sized intermediate.  Identity-basis (multivariate family)
    shortcut: G_n = I, so the matvec collapses."""
    if data.identity_basis:
        Gw = w_excl
    else:
        Gw = jnp.einsum("npq,nq->np", data.G, w_excl, **_HI)
    return jnp.einsum("n,np->p", wt, data.u - Gw, **_HI)


def _weighted_gram(data, W):
    """sum_n W[..., n] * G_n as (..., P, P) — the data-precision block of
    every blocked kernel.  Identity-basis shortcut avoids contracting the
    dense (N, P, P) G when every G_n is the identity."""
    P = data.G.shape[-1]
    if data.identity_basis:
        s = jnp.sum(W, axis=-1)
        return s[..., None, None] * jnp.eye(P, dtype=data.G.dtype)
    return jnp.einsum("...n,npq->...pq", W, data.G, **_HI)


# One-shot JOINT sampling of a whole blocked family (all (j,m[,d]) blocks of
# Phi or xi at once): above this joint dimension (B*P) the memory/FLOPs of
# the dense joint precision outgrow its benefit and the kernels fall back to
# the sequential blocked scan.  4096 -> a 4096^2 f32 precision (64 MB) and a
# ~2e10-FLOP Cholesky per chain.
_JOINT_MAX_DIM = 4096


def _joint_blocked_draw(key, data, s, W, prior_diag, blocks_cur, w):
    """Exact joint MVN draw of ALL blocks of one blocked-Gibbs family.

    The reference (and the sequential path below) draws the B = K*M(*D)
    blocks of Phi/xi one at a time with loop-carried dependencies through
    the running mean coefficients (UpdatePhi.h:23-89, UpdateXi.h:26-93).
    The stacked conditional of [x_1 .. x_B] given everything else is itself
    Gaussian:

        A[(a,p),(b,q)] = s * sum_n W_an W_bn G_n[p,q]
                         + delta_ab delta_pq prior_diag[a,p]
        b[(a,p)]       = s * sum_n W_an (u_n - G_n w_excl_n)[p]

    so ONE Cholesky of dimension B*P — large, batched MXU work — replaces B
    serial P-dim draws, and the draw targets the exact joint conditional
    (a strictly better-mixing Gibbs kernel than the sequential scan).

    W: (B, N) per-block observation weights; blocks_cur: (B, P) current
    values (their contribution is removed via the cache); prior_diag:
    (B, P).  Returns (blocks_new, w_new).
    """
    B, N = W.shape
    P = blocks_cur.shape[1]
    w_excl = w - jnp.einsum("bn,bp->np", W, blocks_cur, **_HI)
    if data.identity_basis:
        resid = data.u - w_excl
        C = jnp.einsum("an,bn->ab", W, W, **_HI)
        A = C[:, None, :, None] \
            * jnp.eye(P, dtype=W.dtype)[None, :, None, :]
    else:
        Gw = jnp.einsum("npq,nq->np", data.G, w_excl, **_HI)
        resid = data.u - Gw
        A = jnp.einsum("an,bn,npq->apbq", W, W, data.G, **_HI)
    bvec = s * jnp.einsum("bn,np->bp", W, resid, **_HI).reshape(B * P)
    A = (s * A).reshape(B * P, B * P) \
        + jnp.diag(prior_diag.reshape(B * P))
    with jax.named_scope("joint_precision_draw"):
        new, _ = mvn_from_precision_fused(key, A, bvec)
    blocks_new = new.reshape(B, P)
    w_new = w_excl + jnp.einsum("bn,bp->np", W, blocks_new, **_HI)
    return blocks_new, w_new


# ---------------------------------------------------------------------------
# Z — mixed membership rows (MH with Dirichlet random-walk proposal)
# Reference: updateZ_PM / updateZTempered_PM (UpdateMixedMembership.h:131-261)
# and the CovAdj variants (:615-1006).  All N rows are conditionally
# independent given (nu, Phi, chi, pi, alpha_3, sigma2), so the reference's
# sequential loop over i is replaced by one fully-vectorized batch.
# ---------------------------------------------------------------------------

def update_z(key, state, data, hp, cache: SweepCache, beta=1.0):
    # Per-row Gaussian log-likelihood evaluated in residual space: the
    # Gram-identity quadratic yy - 2 z·(T u) + z'(T G T')z cancels
    # catastrophically in f32 (error ~ eps*||y_n||^2 can flip MH decisions
    # on high-SNR data), so the MH endpoints materialize the length-L
    # residual — both endpoints STACKED into one (2N, L, P)-batched pass so
    # the sweep's largest einsum runs once, not twice (per-sweep-latency
    # item, round-2 VERDICT #4).
    T = feature_offsets(state, data.X)                     # (N, K, P)

    def row_loglik2(Z2):
        """Stacked (2, N, K) -> (2, N) row log-likelihoods in one pass."""
        w = jnp.einsum("enk,nkp->enp", Z2, T, **_HI)
        if getattr(data, "identity_basis", False):
            r = data.y[None] - w
        else:
            r = data.y[None] - jnp.einsum("nlp,enp->enl", data.B, w, **_HI)
        return -beta * jnp.sum(r * r, axis=-1) / (2.0 * state.sigma2)

    def row_lprior2(Z2):
        return jnp.sum((state.alpha3 * state.pi - 1.0) * jnp.log(Z2),
                       axis=-1)

    kp, ka = jax.random.split(key)
    prop_keys = jax.random.split(kp, data.N)
    Z_new = jax.vmap(rdirichlet)(prop_keys, hp.a_Z_PM * state.Z)

    Z2 = jnp.stack([state.Z, Z_new])
    ll = row_loglik2(Z2)
    lpr = row_lprior2(Z2)
    lp_old = ll[0] + lpr[0]
    lp_new = ll[1] + lpr[1]
    # Hastings correction for the Dirichlet random walk — both directions
    # in ONE stacked density call (halves the lgamma op count; lgamma is
    # among the sweep's priciest VPU transcendentals)
    q2 = dirichlet_logpdf_unnormalized(
        jnp.stack([Z_new, state.Z]),
        hp.a_Z_PM * jnp.stack([state.Z, Z_new]))
    log_acc = lp_new - lp_old + q2[1] - q2[0]

    # Auto-accept escape hatch when the current row touched the boundary
    # (UpdateMixedMembership.h:170-174).
    boundary = jnp.any(state.Z <= 0.0, axis=1)
    u = jax.random.uniform(ka, (data.N,))
    accept = jnp.where(jnp.isnan(log_acc), False, jnp.log(u) < log_acc)
    accept = accept | boundary
    Z = jnp.where(accept[:, None], Z_new, state.Z)
    w = jnp.einsum("nk,nkp->np", Z, T, **_HI)
    return state.replace(Z=Z), cache.replace(w=w)


# ---------------------------------------------------------------------------
# (Z, chi) — partially collapsed block update.
#
# NOT a reference kernel: the reference's updateZ_PM conditions on chi
# (UpdateMixedMembership.h:131-185), which couples Z_i to its current score
# vector chi_i and leaves a slowly-mixing direction the conditional sweep
# cannot cross (measured: cross-chain R-hat on fitted-curve probes plateaus
# at ~1.6 even after 20k sweeps; BENCH_SUITE.md operating-point study).
#
# This kernel instead
#   1. MH-updates each Z row against the CHI-MARGINAL row likelihood
#        y_i | Z_i ~ N(B_i a_i(Z_i),  sigma2/beta I + F_i F_i'),
#        a_i = sum_k Z_ik (nu_k + eta_k x_i),  F_i = B_i U_i,
#        U_i = sum_k Z_ik (Phi_k + xi_k x_i),
#      evaluated via the matrix-determinant lemma / Woodbury in M-space
#      (exactly the CPO marginal, CalculateLikelihood.h:361-372), then
#   2. immediately redraws ALL chi rows jointly from their exact Gaussian
#      conditional given the new Z (precision I_M + s U'GU — one batched
#      M x M Cholesky replacing the sequential M-loop of update_chi).
#
# The composition (MH invariant for the chi-marginal of Z) followed by
# (exact draw of chi | Z) leaves the JOINT posterior invariant — the
# partially-collapsed-Gibbs ordering of Van Dyk & Park (2008); nothing
# reads the stale chi in between.  Tempering: [lik]^beta has effective
# variance sigma2/beta, so marginalizing chi gives the covariance above and
# the chi redraw precision I + beta F'F/sigma2 — matching updateChiTempered
# (UpdateChi.h:79-134).  Joint invariance is proven by the Geweke test of
# the collapsed sweep (tests/test_geweke_covadj.py::
# test_geweke_collapsed_gauge_sweep).
# ---------------------------------------------------------------------------

def _mean_only_offsets(state, X):
    """T[n,k,p] = nu_k + eta_k x_n — feature mean coefficients, chi terms
    excluded (the chi-marginal kernel's mean structure)."""
    N = X.shape[0]
    T = jnp.broadcast_to(state.nu[None], (N,) + state.nu.shape)
    if X.shape[1] > 0:
        T = T + jnp.einsum("kpd,nd->nkp", state.eta, X, **_HI)
    return T


def _feature_eigendirs(state, X):
    """V[n,k,p,m] = Phi_k + xi_k x_n — per-observation eigen-directions of
    each feature (Z-independent)."""
    N = X.shape[0]
    V = jnp.broadcast_to(state.Phi[None], (N,) + state.Phi.shape)
    if X.shape[1] > 0:
        V = V + jnp.einsum("kpdm,nd->nkpm", state.xi, X, **_HI)
    return V


def update_z_chi(key, state, data, hp, cache: SweepCache, beta=1.0,
                 p_indep=0.3, label_swap=True, anchor_prop=False,
                 anchor_conc=300.0):
    """Collapsed (Z, chi) block update; see block comment above.

    Proposal: a mixture — with probability ``p_indep`` an INDEPENDENCE draw
    from Dir(alpha3 * pi) (the Z-row prior), else the reference's local
    Dirichlet random walk Dir(a_Z_PM * Z_i).  The local walk's ~1% steps
    cannot hop between per-observation allocation basins (measured: loglik
    cross-chain R-hat plateaus at 1.6 under pure random-walk Z); the
    independence component jumps basins, and the chi-marginal target means
    a jump is judged on the allocation's own merit rather than through the
    stale chi_i.  The Hastings ratio uses the full mixture density both
    ways, so the kernel is exact for any p_indep in [0, 1).

    ``p_indep`` default 0.3 is the measured optimum of the round-4 sweep
    (benchmarks/operating_point.py --collapsed --p_indep, 256 chains, 20k
    warmup, 5k kept): rhat_max 1.066 / ESS 7500 at 0.3 vs 1.102/4754 at
    0.1 and 1.098/4892 at 0.5; the reference chi-conditional kernel at the
    same budget sits at rhat_max 1.63 / ESS 1807.
    """
    s = beta / state.sigma2
    Tm = _mean_only_offsets(state, data.X)        # (N, K, P)
    Mm = state.M
    # per-column feature eigen-directions: V_m[n, k, p] = Phi_k[:, m]
    # (+ xi_k[:, :, m] x_n) — built per column so no (N, K, P, M) or
    # (E, N, M, M) trailing-small tensor is ever materialized (the
    # entries-interface rationale, ops/linalg.py; measured round 5)
    if data.X.shape[1] > 0:
        Vl = [state.Phi[None, :, :, m]
              + jnp.einsum("kpd,nd->nkp", state.xi[:, :, :, m], data.X,
                           **_HI) for m in range(Mm)]
    else:
        Vl = [state.Phi[:, :, m] for m in range(Mm)]

    def row_stats(Z2):
        """Stacked endpoints: Z2 (E, N, K) -> per-endpoint stats (E, ...).

        One batched pass for both MH endpoints halves the dispatch count of
        the kernel's large einsums (per-sweep-latency, VERDICT #4)."""
        a = jnp.einsum("enk,nkp->enp", Z2, Tm, **_HI)         # (E, N, P)
        if data.X.shape[1] > 0:
            Ul = [jnp.einsum("enk,nkp->enp", Z2, V, **_HI) for V in Vl]
        else:
            Ul = [jnp.einsum("enk,kp->enp", Z2, V, **_HI) for V in Vl]
        if data.identity_basis:
            GUl, Ga = Ul, a
            r = data.y[None] - a
        else:
            GUl = [jnp.einsum("npq,enq->enp", data.G, u, **_HI)
                   for u in Ul]
            Ga = jnp.einsum("npq,enq->enp", data.G, a, **_HI)
            r = data.y[None] - jnp.einsum("nlp,enp->enl", data.B, a, **_HI)
        ur = data.u[None] - Ga
        C = [[(1.0 if i == j else 0.0)
              + s * jnp.einsum("enp,enp->en", Ul[i], GUl[j], **_HI)
              for j in range(i + 1)] for i in range(Mm)]
        Fr = [jnp.einsum("enp,enp->en", u, ur, **_HI) for u in Ul]
        rr = jnp.sum(r * r, axis=-1)                           # residual space
        Lc = small_chol_entries(C)
        return a, Ul, Lc, Fr, rr

    def marg_loglik(Lc, Fr, rr):
        wv = small_solve_lower_entries(Lc, Fr)
        quad = s * rr - s * s * sum(v * v for v in wv)
        return -0.5 * (small_logdet_entries(Lc) + quad)

    def row_lprior2(Z2):
        return jnp.sum((state.alpha3 * state.pi - 1.0) * jnp.log(Z2),
                       axis=-1)

    kp, ki, kb, ka, kc = jax.random.split(key, 5)
    prop_keys = jax.random.split(kp, data.N)
    Z_rw = jax.vmap(rdirichlet)(prop_keys, hp.a_Z_PM * state.Z)
    alpha_ind = jnp.broadcast_to(state.alpha3 * state.pi, state.Z.shape)
    Z_ind = jax.vmap(rdirichlet)(jax.random.split(ki, data.N), alpha_ind)
    use_ind = jax.random.uniform(kb, (data.N,)) < p_indep
    Z_new = jnp.where(use_ind[:, None], Z_ind, Z_rw)

    def log_q_mix2(z_new, z_old):
        """Both mixture proposal densities q(new|old), q(old|new) in one
        stacked density evaluation (one lgamma pass instead of four)."""
        tos = jnp.stack([z_new, z_old, z_new, z_old])
        alphas = jnp.concatenate([hp.a_Z_PM * jnp.stack([z_old, z_new]),
                                  jnp.stack([alpha_ind, alpha_ind])])
        ld = dirichlet_logpdf_unnormalized(tos, alphas)
        if p_indep <= 0.0:
            return ld[0], ld[1]
        fwd = jnp.logaddexp(jnp.log(p_indep) + ld[2],
                            jnp.log1p(-p_indep) + ld[0])
        bwd = jnp.logaddexp(jnp.log(p_indep) + ld[3],
                            jnp.log1p(-p_indep) + ld[1])
        return fwd, bwd

    Zstack = jnp.stack([state.Z, Z_new])
    a2, Ul2, Lc2, Fr2, rr2 = row_stats(Zstack)
    lpr = row_lprior2(Zstack)
    ml = marg_loglik(Lc2, Fr2, rr2)                 # (2, N)
    lp_old = ml[0] + lpr[0]
    lp_new = ml[1] + lpr[1]
    q_fwd, q_bwd = log_q_mix2(Z_new, state.Z)
    log_acc = lp_new - lp_old + q_bwd - q_fwd
    boundary = jnp.any(state.Z <= 0.0, axis=1)
    u = jax.random.uniform(ka, (data.N,))
    accept = jnp.where(jnp.isnan(log_acc), False, jnp.log(u) < log_acc)
    accept = accept | boundary
    acc = accept[:, None]
    Z = jnp.where(acc, Z_new, state.Z)
    a = jnp.where(acc, a2[1], a2[0])
    Ul = [jnp.where(acc, u_[1], u_[0]) for u_ in Ul2]
    Lc = [[jnp.where(accept, e[1], e[0]) for e in row] for row in Lc2]
    Fr = [jnp.where(accept, f[1], f[0]) for f in Fr2]
    ml_cur = jnp.where(accept, ml[1], ml[0])
    lpr_cur = jnp.where(accept, lpr[1], lpr[0])

    if label_swap:
        # ---- per-row LABEL-SWAP stage (round-5; not a reference move) ----
        # The freeze-test attribution (BENCH_SUITE.md round 5) shows the
        # fit level is a function of Z alone: with Z frozen the loglik
        # cannot move, and the residual cross-chain R-hat is carried by
        # rare per-row allocation-basin changes the ~1% Dirichlet walk
        # cannot make and the prior-independence draw rarely lands in.
        # This stage proposes swapping two random coordinates of each row
        # — the exact jump between a row's allocation basins.  Picking an
        # ordered pair uniformly and swapping is an involution with a
        # symmetric kernel, so the MH ratio is just the (chi-marginal)
        # posterior ratio; judged with the same row_stats machinery and
        # composed before the single chi redraw (both stages target the
        # chi-marginal; nothing reads stale chi in between).
        kp1, kp2, ks_u = jax.random.split(jax.random.fold_in(key, 97), 3)
        K = state.Z.shape[1]
        i1 = jax.random.randint(kp1, (data.N,), 0, K)
        r2 = jax.random.randint(kp2, (data.N,), 0, K - 1)
        i2 = jnp.where(r2 >= i1, r2 + 1, r2)
        cols = jnp.arange(K)[None, :]
        sel1 = cols == i1[:, None]
        sel2 = cols == i2[:, None]
        z_i1 = jnp.sum(jnp.where(sel1, Z, 0.0), axis=1, keepdims=True)
        z_i2 = jnp.sum(jnp.where(sel2, Z, 0.0), axis=1, keepdims=True)
        Z_swap = jnp.where(sel1, z_i2, jnp.where(sel2, z_i1, Z))
        # single-endpoint evaluation: the current endpoint's stats and
        # (marginal ll, prior) are carried from the first stage
        a2s, Ul2s, Lc2s, Fr2s, rr2s = row_stats(Z_swap[None])
        ml_s = marg_loglik(Lc2s, Fr2s, rr2s)[0]
        lpr_s = row_lprior2(Z_swap[None])[0]
        log_acc_s = (ml_s + lpr_s) - (ml_cur + lpr_cur)
        u_s = jax.random.uniform(ks_u, (data.N,))
        acc_s1 = jnp.where(jnp.isnan(log_acc_s), False,
                           jnp.log(u_s) < log_acc_s)
        accs = acc_s1[:, None]
        Z = jnp.where(accs, Z_swap, Z)
        a = jnp.where(accs, a2s[0], a)
        Ul = [jnp.where(accs, n_[0], o_) for n_, o_ in zip(Ul2s, Ul)]
        Lc = [[jnp.where(acc_s1, n_[0], o_)
               for n_, o_ in zip(nrow, orow)]
              for nrow, orow in zip(Lc2s, Lc)]
        Fr = [jnp.where(acc_s1, n_[0], o_) for n_, o_ in zip(Fr2s, Fr)]
        ml_cur = jnp.where(acc_s1, ml_s, ml_cur)
        lpr_cur = jnp.where(acc_s1, lpr_s, lpr_cur)

    if anchor_prop:
        # ---- ANCHOR-GUIDED independence stage (round 5) ----------------
        # The 100k-window measurement shows per-chain allocation basins
        # that neither the ~1% Dirichlet walk, the prior-independence
        # draw, nor the coordinate swap reaches within 10^5 sweeps
        # (BENCH_SUITE.md round-5 §3) — basins whose shape (e.g. a
        # 60/0/40 split vs a 55/45/0 split) is far from every proposal's
        # mass.  This stage evaluates each row's chi-marginal
        # log-likelihood at the K CORNER anchors e_k (state-independent
        # points, so the anchor weights are identical for the forward and
        # reverse densities), picks an anchor from softmax of those
        # values, and proposes z' ~ Dir(conc * e_a + 1/2) — a draw aimed
        # at the basin the row's own marginal landscape prefers.  The
        # Hastings ratio uses the full mixture density
        # q(z) = sum_a P(a) Dir(z; conc e_a + 1/2) both ways (the shared
        # normalizer cancels).  Rows currently touching the simplex
        # boundary are excluded (q is improper at exact zeros).
        K = state.Z.shape[1]
        corners = jnp.eye(K, dtype=Z.dtype)                    # (K, K)
        ka1, ka2, ka3 = jax.random.split(jax.random.fold_in(key, 131), 3)
        # marginal ll at the K corners: one stacked row_stats pass
        Zc = jnp.broadcast_to(corners[:, None, :], (K, data.N, K))
        _, _, Lc_c, Fr_c, rr_c = row_stats(Zc)
        ml_c = marg_loglik(Lc_c, Fr_c, rr_c)                   # (K, N)
        Pa = jax.nn.softmax(ml_c, axis=0)                      # (K, N)
        a_sel = jax.random.categorical(ka1, ml_c.T)            # (N,)
        alpha_prop = anchor_conc * corners[a_sel] + 0.5        # (N, K)
        Z_anchor = jax.vmap(rdirichlet)(
            jax.random.split(ka2, data.N), alpha_prop)

        def log_q_anchor(z):
            """log sum_a P(a) Dir_unnorm(z; conc e_a + 1/2) per row."""
            # per anchor a the exponent is (conc + 1/2 - 1) log z_a
            # + sum_{k != a} (1/2 - 1) log z_k
            #   = -1/2 sum_k log z_k + conc log z_a
            lz = jnp.log(z)                                    # (N, K)
            base = -0.5 * jnp.sum(lz, axis=1)                  # (N,)
            per_a = base[None, :] + anchor_conc * lz.T         # (K, N)
            return jax.scipy.special.logsumexp(
                per_a + jnp.log(Pa + 1e-38), axis=0)           # (N,)

        a3s, Ul3s, Lc3s, Fr3s, rr3s = row_stats(Z_anchor[None])
        ml_a = marg_loglik(Lc3s, Fr3s, rr3s)[0]
        lpr_a = row_lprior2(Z_anchor[None])[0]
        log_acc_a = ((ml_a + lpr_a) - (ml_cur + lpr_cur)
                     + log_q_anchor(Z) - log_q_anchor(Z_anchor))
        interior = jnp.all(Z > 0.0, axis=1)
        u_a = jax.random.uniform(ka3, (data.N,))
        acc_a1 = interior & jnp.where(jnp.isnan(log_acc_a), False,
                                      jnp.log(u_a) < log_acc_a)
        acca = acc_a1[:, None]
        Z = jnp.where(acca, Z_anchor, Z)
        a = jnp.where(acca, a3s[0], a)
        Ul = [jnp.where(acca, n_[0], o_) for n_, o_ in zip(Ul3s, Ul)]
        Lc = [[jnp.where(acc_a1, n_[0], o_)
               for n_, o_ in zip(nrow, orow)]
              for nrow, orow in zip(Lc3s, Lc)]
        Fr = [jnp.where(acc_a1, n_[0], o_) for n_, o_ in zip(Fr3s, Fr)]

    # exact joint chi | Z draw: precision C = I + s U'GU, linear b = s F'r
    z = jax.random.normal(kc, (Mm, data.N), state.chi.dtype)
    mean = small_solve_upper_t_entries(
        Lc, small_solve_lower_entries(Lc, [s * f for f in Fr]))
    noise = small_solve_upper_t_entries(Lc, [z[m] for m in range(Mm)])
    chi_cols = [mean[m] + noise[m] for m in range(Mm)]
    w = a
    for m in range(Mm):
        w = w + chi_cols[m][:, None] * Ul[m]
    chi = jnp.stack(chi_cols, axis=-1)
    return state.replace(Z=Z, chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# pi — population allocation (MH with Dirichlet proposal)
# Reference: updatePi_PM / lpdf_pi_PM (UpdatePi.h:39-116)
# ---------------------------------------------------------------------------

def update_pi(key, state, hp, c):
    logZ_colsum = jnp.sum(jnp.log(state.Z), axis=0)
    N = state.Z.shape[0]

    def lpdf(pi):
        return (jnp.sum((c - 1.0) * jnp.log(pi))
                + jnp.sum((state.alpha3 * pi - 1.0) * logZ_colsum)
                - N * log_multi_beta(state.alpha3 * pi))

    kp, ka = jax.random.split(key)
    pi_new = rdirichlet(kp, hp.a_pi_PM * state.pi)
    log_acc = (lpdf(pi_new) - lpdf(state.pi)
               + dirichlet_logpdf_unnormalized(state.pi, hp.a_pi_PM * pi_new)
               - dirichlet_logpdf_unnormalized(pi_new, hp.a_pi_PM * state.pi))
    u = jax.random.uniform(ka)
    accept = jnp.where(jnp.isnan(log_acc), False, jnp.log(u) < log_acc)
    return state.replace(pi=jnp.where(accept, pi_new, state.pi))


# ---------------------------------------------------------------------------
# alpha_3 — Dirichlet concentration (truncated-normal MH)
# Reference: updateAlpha3 / lpdf_alpha3 (UpdateAlpha3.h:10-63).  Deviation:
# the reference's Hastings term evaluates d_truncnorm at the proposal
# centered on itself (UpdateAlpha3.h:23-24), which reduces to the truncation
# normalizer with the wrong sign; we apply the standard correct correction
# q(old|new) - q(new|old).  Posterior-moment impact is negligible for
# sd=0.05 but documented here for the parity audit.
# ---------------------------------------------------------------------------

def update_alpha3(key, state, hp):
    logZ_colsum = jnp.sum(jnp.log(state.Z), axis=0)
    N = state.Z.shape[0]

    def lpdf(a3):
        return (-hp.b * a3
                + jnp.sum((a3 * state.pi - 1.0) * logZ_colsum)
                - N * log_multi_beta(a3 * state.pi))

    kp, ka = jax.random.split(key)
    sd = hp.var_alpha3
    a_new = truncnorm_sample(kp, state.alpha3, sd)
    log_acc = (lpdf(a_new) - lpdf(state.alpha3)
               + truncnorm_logpdf(state.alpha3, a_new, sd)
               - truncnorm_logpdf(a_new, state.alpha3, sd))
    u = jax.random.uniform(ka)
    accept = jnp.where(jnp.isnan(log_acc), False, jnp.log(u) < log_acc)
    return state.replace(alpha3=jnp.where(accept, a_new, state.alpha3))


# ---------------------------------------------------------------------------
# nu — feature mean coordinates (blocked Gibbs, one K-row at a time)
# Reference: updateNu (UpdateNu.h:24-74), tempered (:93-144), MV (:160-204),
# CovAdj (:287+).  Conditional: row j ~ MVN with
#   precision = (beta/sigma2) * sum_i Z_ij^2 B_i' B_i + tau_j * pen
#   linear    = (beta/sigma2) * sum_i Z_ij B_i' r_ij
# where r_ij excludes feature j's own mean term only.
# ---------------------------------------------------------------------------

def update_nu(key, state, data, hp, cache: SweepCache, beta=1.0):
    K = state.K
    s = beta / state.sigma2
    # All K block precisions depend only on (Z, tau, sigma2) — factor them
    # in one batched Cholesky; the sequential loop keeps only the bvec and
    # two P-dim triangular solves.
    prec = s * _weighted_gram(data, (state.Z * state.Z).T) \
        + state.tau[:, None, None] * data.pen
    Lc = chol_precision(prec)

    def body(j, carry):
        nu, w = carry
        zj = state.Z[:, j]
        w_excl = w - zj[:, None] * nu[j]
        bvec = s * _gram_bvec(data, zj, w_excl)
        nu_j, _ = mvn_from_chol(jax.random.fold_in(key, j), Lc[j], bvec)
        w = w_excl + zj[:, None] * nu_j
        nu = nu.at[j].set(nu_j)
        return nu, w

    nu, w = jax.lax.fori_loop(
        0, K, body, (state.nu, cache.w), unroll=_unroll(K))
    return state.replace(nu=nu), cache.replace(w=w)


# ---------------------------------------------------------------------------
# eta — covariate-adjusted mean coordinates (blocked Gibbs over (d, j))
# Reference: updateEta (UpdateEta.h:28-94); loop order d outer, j inner.
# ---------------------------------------------------------------------------

def update_eta(key, state, data, hp, cache: SweepCache, beta=1.0):
    K, D = state.K, data.D
    if D == 0:
        return state, cache

    s = beta / state.sigma2
    Z2X2 = jnp.einsum("nd,nj->djn", data.X * data.X, state.Z * state.Z,
                      **_HI)
    prec = s * _weighted_gram(data, Z2X2) \
        + state.tau_eta.T[:, :, None, None] * data.pen   # (D, K, P, P)
    Lc = chol_precision(prec.reshape(D * K, prec.shape[-1], prec.shape[-1]))

    def body(idx, carry):
        eta, w = carry
        d = idx // K
        j = idx % K
        wt = state.Z[:, j] * data.X[:, d]
        eta_jd = jax.lax.dynamic_slice(
            eta, (j, 0, d), (1, eta.shape[1], 1))[0, :, 0]
        w_excl = w - wt[:, None] * eta_jd
        bvec = s * _gram_bvec(data, wt, w_excl)
        new, _ = mvn_from_chol(jax.random.fold_in(key, idx), Lc[idx], bvec)
        w = w_excl + wt[:, None] * new
        eta = jax.lax.dynamic_update_slice(eta, new[None, :, None], (j, 0, d))
        return eta, w

    eta, w = jax.lax.fori_loop(
        0, D * K, body, (state.eta, cache.w), unroll=_unroll(D * K))
    return state.replace(eta=eta), cache.replace(w=w)


# ---------------------------------------------------------------------------
# Phi — pseudo-eigenfunction coordinates (blocked Gibbs over (j, m))
# Reference: updatePhi (UpdatePhi.h:23-89); prior precision is diagonal
# tilde_tau(j,m) * gamma(j,:,m) (UpdatePhi.h:76-78) with
# tilde_tau = cumprod(delta) computed in the driver (BFMMM.h:1514-1519).
# ---------------------------------------------------------------------------

def update_phi(key, state, data, hp, cache: SweepCache, beta=1.0):
    K, M = state.K, state.M
    P = state.Phi.shape[1]
    tilde_tau = jnp.cumprod(state.delta, axis=1)  # (K, M)
    s = beta / state.sigma2
    prior_diag = tilde_tau[:, :, None] * state.gamma.transpose(0, 2, 1)

    if K * M * P <= _JOINT_MAX_DIM:
        W = jnp.einsum("nj,nm->jmn", state.Z, state.chi,
                       **_HI).reshape(K * M, -1)
        blocks = state.Phi.transpose(0, 2, 1).reshape(K * M, P)
        new, w = _joint_blocked_draw(key, data, s, W,
                                     prior_diag.reshape(K * M, P),
                                     blocks, cache.w)
        Phi = new.reshape(K, M, P).transpose(0, 2, 1)
        return state.replace(Phi=Phi), cache.replace(w=w)

    wsq = jnp.einsum("nj,nm->jmn", state.Z * state.Z, state.chi * state.chi,
                     **_HI)
    prec = s * _weighted_gram(data, wsq) \
        + prior_diag[..., :, None] * jnp.eye(P, dtype=state.Phi.dtype)
    Lc = chol_precision(prec.reshape(K * M, P, P))

    def body(idx, carry):
        Phi, w = carry
        j = idx // M
        m = idx % M
        wt = state.Z[:, j] * state.chi[:, m]
        w_excl = w - wt[:, None] * Phi[j, :, m]
        bvec = s * _gram_bvec(data, wt, w_excl)
        new, _ = mvn_from_chol(jax.random.fold_in(key, idx), Lc[idx], bvec)
        w = w_excl + wt[:, None] * new
        Phi = Phi.at[j, :, m].set(new)
        return Phi, w

    Phi, w = jax.lax.fori_loop(
        0, K * M, body, (state.Phi, cache.w), unroll=_unroll(K * M))
    return state.replace(Phi=Phi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# xi — covariate-adjusted eigen coordinates (blocked Gibbs over (j, m, d))
# Reference: updateXiCovariateAdj (UpdateXi.h:26-93); prior precision
# tilde_tau_xi(j,m,d) * gamma_xi(j,:,d,m) (UpdateXi.h:77-79).
# ---------------------------------------------------------------------------

def update_xi(key, state, data, hp, cache: SweepCache, beta=1.0):
    K, M, D = state.K, state.M, data.D
    if D == 0:
        return state, cache
    tilde_tau_xi = jnp.cumprod(state.delta_xi, axis=1)  # (K, M, D)
    P = state.xi.shape[1]
    s = beta / state.sigma2
    # gamma_xi is (K, P, D, M) -> diag vectors ordered (j, m, d, P)
    prior_diag = tilde_tau_xi[..., None] \
        * state.gamma_xi.transpose(0, 3, 2, 1)            # (K, M, D, P)

    if K * M * D * P <= _JOINT_MAX_DIM:
        # One joint draw of ALL K*M*D blocks — this was the sweep's serial
        # bottleneck (round-1 VERDICT: config 4's K*M*D fori_loop).
        W = jnp.einsum("nj,nm,nd->jmdn", state.Z, state.chi,
                       data.X, **_HI).reshape(K * M * D, -1)
        blocks = state.xi.transpose(0, 3, 2, 1).reshape(K * M * D, P)
        new, w = _joint_blocked_draw(key, data, s, W,
                                     prior_diag.reshape(K * M * D, P),
                                     blocks, cache.w)
        xi = new.reshape(K, M, D, P).transpose(0, 3, 2, 1)
        return state.replace(xi=xi), cache.replace(w=w)

    wsq = jnp.einsum("nj,nm,nd->jmdn", state.Z * state.Z,
                     state.chi * state.chi, data.X * data.X, **_HI)
    prec = s * _weighted_gram(data, wsq) \
        + prior_diag[..., :, None] * jnp.eye(P, dtype=state.xi.dtype)
    Lc = chol_precision(prec.reshape(K * M * D, P, P))

    def body(idx, carry):
        xi, w = carry
        j = idx // (M * D)
        m = (idx // D) % M
        d = idx % D
        wt = state.Z[:, j] * state.chi[:, m] * data.X[:, d]
        w_excl = w - wt[:, None] * xi[j, :, d, m]
        bvec = s * _gram_bvec(data, wt, w_excl)
        new, _ = mvn_from_chol(jax.random.fold_in(key, idx), Lc[idx], bvec)
        w = w_excl + wt[:, None] * new
        xi = xi.at[j, :, d, m].set(new)
        return xi, w

    xi, w = jax.lax.fori_loop(
        0, K * M * D, body, (state.xi, cache.w), unroll=_unroll(K * M * D))
    return state.replace(xi=xi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# chi — per-observation eigen scores (scalar Gibbs, vectorized over N)
# Reference: updateChi (UpdateChi.h:19-64): posterior precision 1 + W/sigma2.
# All observations are independent; only the M loop is sequential.
# ---------------------------------------------------------------------------

def update_chi(key, state, data, hp, cache: SweepCache, beta=1.0):
    M = state.M
    s = beta / state.sigma2
    U = eigen_directions(state, data.X)                      # (N, P, M)
    # Gram space: F_nm = B_n U_nm is never formed.  F'F = U'GU and
    # F'y = U·u precompute for ALL m at once; the loop keeps dot products.
    GU = U if data.identity_basis \
        else jnp.einsum("npq,nqm->npm", data.G, U, **_HI)    # (N, P, M)
    Wden = 1.0 + s * jnp.einsum("npm,npm->nm", U, GU, **_HI)  # (N, M)
    uU = jnp.einsum("np,npm->nm", data.u, U, **_HI)          # (N, M)

    def body(m, carry):
        chi, w = carry
        Um = jax.lax.dynamic_index_in_dim(U, m, 2, False)       # (N, P)
        GUm = jax.lax.dynamic_index_in_dim(GU, m, 2, False)     # (N, P)
        cm = jax.lax.dynamic_index_in_dim(chi, m, 1, False)     # (N,)
        w_excl = w - cm[:, None] * Um
        fr = jax.lax.dynamic_index_in_dim(uU, m, 1, False) \
            - jnp.einsum("np,np->n", GUm, w_excl, **_HI)        # F_m' r
        Wm = jax.lax.dynamic_index_in_dim(Wden, m, 1, False)
        z = jax.random.normal(jax.random.fold_in(key, m), fr.shape, fr.dtype)
        new = s * fr / Wm + z / jnp.sqrt(Wm)
        w = w_excl + new[:, None] * Um
        chi = jax.lax.dynamic_update_index_in_dim(chi, new, m, 1)
        return chi, w

    chi, w = jax.lax.fori_loop(0, M, body, (state.chi, cache.w),
                               unroll=_unroll(M))
    return state.replace(chi=chi), cache.replace(w=w)


def update_chi_joint(key, state, data, hp, cache: SweepCache, beta=1.0):
    """Exact JOINT draw of every chi row (all M scores at once).

    NOT a reference kernel: updateChi (UpdateChi.h:19-64) Gibbs-scans the M
    scores sequentially; the joint conditional of the whole row chi_i is
    Gaussian with precision I_M + s U_i'G_i U_i and linear term
    s U_i'(u_i - G_i a_i) — one batched M x M Cholesky over N observations
    replaces M sequential dependent steps (same joint chi machinery as
    update_z_chi's redraw; exactness covered by the collapsed-sweep Geweke
    test).  Used by the production sweep."""
    s = beta / state.sigma2
    U = eigen_directions(state, data.X)                      # (N, P, M)
    a = cache.w - jnp.einsum("npm,nm->np", U, state.chi, **_HI)
    Mm = state.M
    # entries form: the (N, M, M) precision is never materialized — its
    # trailing-(M, M) layout tiles to (8, 128) vregs, a ~32x HBM blowup
    # paid by the building einsum and every later slice (ops/linalg.py
    # entries-interface rationale; measured in BENCH_SUITE.md round 5)
    Ul = [U[:, :, m] for m in range(Mm)]
    if data.identity_basis:
        GUl, Ga = Ul, a
    else:
        GUl = [jnp.einsum("npq,nq->np", data.G, u, **_HI) for u in Ul]
        Ga = jnp.einsum("npq,nq->np", data.G, a, **_HI)
    ur = data.u - Ga
    C = [[(1.0 if i == j else 0.0)
          + s * jnp.einsum("np,np->n", Ul[i], GUl[j], **_HI)
          for j in range(i + 1)] for i in range(Mm)]
    b = [s * jnp.einsum("np,np->n", Ul[m], ur, **_HI) for m in range(Mm)]
    Lc = small_chol_entries(C)
    z = jax.random.normal(key, (Mm, data.N), state.chi.dtype)
    mean = small_solve_upper_t_entries(Lc, small_solve_lower_entries(Lc, b))
    noise = small_solve_upper_t_entries(Lc, [z[m] for m in range(Mm)])
    chi_cols = [mean[m] + noise[m] for m in range(Mm)]
    w = a
    for m in range(Mm):
        w = w + chi_cols[m][:, None] * Ul[m]
    chi = jnp.stack(chi_cols, axis=-1)
    return state.replace(chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# sigma^2 — residual variance (conjugate inverse-Gamma)
# Reference: updateSigma (UpdateSigma.h:22-58); tempered variant scales both
# shape and rate by beta (UpdateSigma.h:101-103).
# ---------------------------------------------------------------------------

def update_sigma(key, state, data, hp, cache: SweepCache, beta=1.0):
    rss = rss_from_coeffs(data, cache.w)
    a = hp.alpha_0 + beta * data.n_obs_total / 2.0
    b = hp.beta_0 + beta * rss / 2.0
    g = jax.random.gamma(key, a)
    return state.replace(sigma2=b / g)


# ---------------------------------------------------------------------------
# tau — mean smoothness precisions (conjugate Gamma on the penalty quadform)
# Reference: updateTau (UpdateTau.h:18-36).  The MV inverse-Gamma variant
# (UpdateTau.h:47-63) is this same Gamma draw on the precision scale with
# pen = I; trace export reciprocates for the MV family.
# ---------------------------------------------------------------------------

def update_tau(key, state, data, hp):
    P = state.nu.shape[1]
    quad = jnp.einsum("kp,pq,kq->k", state.nu, data.pen, state.nu, **_HI)
    a = hp.alpha_nu + P / 2.0
    rate = hp.beta_nu + 0.5 * quad
    g = jax.random.gamma(key, jnp.full((state.K,), a))
    return state.replace(tau=g / rate)


def update_tau_eta(key, state, data, hp):
    """Reference: updateTauEta (UpdateTau.h:75-95) / MV (:106-124)."""
    if data.D == 0:
        return state
    P = state.eta.shape[1]
    quad = jnp.einsum("kpd,pq,kqd->kd", state.eta, data.pen, state.eta, **_HI)
    a = hp.alpha_eta + P / 2.0
    rate = hp.beta_eta + 0.5 * quad
    g = jax.random.gamma(key, jnp.full(quad.shape, a))
    return state.replace(tau_eta=g / rate)


# ---------------------------------------------------------------------------
# delta — MGP column multipliers (sequential Gibbs over the column index)
# Reference: updateDelta (UpdateDelta.h:17-64):
#   shape_i = a(k, i==0 ? 0 : 1) + P*(M-i)/2
#   rate_i  = 1 + 0.5 sum_j sum_{m>=i} gamma_kjm (prod_{n<=m, n!=i} delta_kn)
#             phi_kjm^2
# ---------------------------------------------------------------------------

def update_delta(key, state, hp):
    K, P, M = state.Phi.shape
    S = jnp.sum(state.gamma * state.Phi**2, axis=1)  # (K, M)
    m_idx = jnp.arange(M)
    # The Gamma SHAPES depend only on A (fixed during this update), so all
    # M standard-Gamma variates come from ONE batched rejection sampler
    # instead of M sequential while_loops; only the rates are sequential
    # (delta_i | delta_{<i}), and G_i / rate_i ~ Gamma(shape_i, rate_i)
    # exactly as before (per-sweep-latency, round-3 VERDICT #4).
    shapes = jnp.where(m_idx[None, :] == 0, state.A[:, :1], state.A[:, 1:2]) \
        + P * (M - m_idx)[None, :] / 2.0                     # (K, M)
    G = jax.random.gamma(key, shapes)

    # rate_i = 1 + 0.5 * sum_{m>=i} S_m * prod_{n<=m, n!=i} delta_n, where
    # delta_n is NEW for n < i and OLD for n > i.  Split the product into
    # prefix (new, carried) x suffix (old, precomputed):
    #   prod = P_i * O_m / O_i,  P_i = prod_{n<i} new_n, O = cumprod(old)
    # so the whole tail sum collapses to P_i * T_i / O_i with ONE
    # precomputed reverse-cumsum T_i = sum_{m>=i} S_m O_m — the loop body
    # shrinks to 4 tiny ops (latency item, kernel_breakdown.py).
    O = jnp.cumprod(state.delta, axis=1)                     # (K, M)
    T = jnp.cumsum((S * O)[:, ::-1], axis=1)[:, ::-1]        # (K, M)

    def body(i, carry):
        delta, pref = carry
        rate = 1.0 + 0.5 * pref * T[:, i] / O[:, i]          # (K,)
        d_i = G[:, i] / rate
        return delta.at[:, i].set(d_i), pref * d_i

    delta, _ = jax.lax.fori_loop(
        0, M, body, (state.delta, jnp.ones_like(state.delta[:, 0])),
        unroll=_unroll(M))
    return state.replace(delta=delta)


def update_delta_xi(key, state, hp):
    """Reference: updateDeltaXi (UpdateDelta.h:76-125); per-covariate MGP.

    Note the reference's shape for i==0 uses P*M/2 but for i>0 uses
    P*(M-i)/2 via ``delta.n_cols`` — the same unified formula as updateDelta.
    """
    if state.delta_xi.shape[2] == 0:
        return state
    K, P, D, M = state.xi.shape[0], state.xi.shape[1], state.xi.shape[2], state.xi.shape[3]
    # S[k, m, d] = sum_j gamma_xi[k,j,d,m] * xi[k,j,d,m]^2
    S = jnp.sum(state.gamma_xi * state.xi**2, axis=1).transpose(0, 2, 1)  # (K, M, D)
    m_idx = jnp.arange(M)
    # one batched standard-Gamma draw for all M columns (see update_delta)
    shapes = jnp.where(m_idx[None, :, None] == 0,
                       state.A_xi[:, None, 0, :], state.A_xi[:, None, 1, :]) \
        + (P * (M - m_idx) / 2.0)[None, :, None]              # (K, M, D)
    G = jax.random.gamma(key, shapes)

    # prefix/suffix product split — see update_delta
    O = jnp.cumprod(state.delta_xi, axis=1)                   # (K, M, D)
    T = jnp.cumsum((S * O)[:, ::-1, :], axis=1)[:, ::-1, :]   # (K, M, D)

    def body(i, carry):
        delta, pref = carry
        rate = 1.0 + 0.5 * pref * T[:, i, :] / O[:, i, :]     # (K, D)
        d_i = G[:, i, :] / rate
        return delta.at[:, i, :].set(d_i), pref * d_i

    delta_xi, _ = jax.lax.fori_loop(
        0, M, body,
        (state.delta_xi, jnp.ones_like(state.delta_xi[:, 0, :])),
        unroll=_unroll(M))
    return state.replace(delta_xi=delta_xi)


# ---------------------------------------------------------------------------
# gamma — local t-scale mixture precisions (fully parallel Gibbs)
# Reference: updateGamma (UpdateGamma.h:17-37):
#   gamma_kjm ~ Gamma((nu1+1)/2, rate = (nu1 + tilde_tau_km phi_kjm^2)/2)
# ---------------------------------------------------------------------------

def update_gamma(key, state, hp):
    tilde_tau = jnp.cumprod(state.delta, axis=1)  # (K, M)
    rate = (hp.nu_1 + tilde_tau[:, None, :] * state.Phi**2) / 2.0
    shape = (hp.nu_1 + 1.0) / 2.0
    g = jax.random.gamma(key, jnp.full(rate.shape, shape))
    return state.replace(gamma=g / rate)


def update_gamma_xi(key, state, hp):
    """Reference: updateGammaXi (UpdateGamma.h:48-73)."""
    if state.gamma_xi.shape[2] == 0:
        return state
    tilde = jnp.cumprod(state.delta_xi, axis=1)            # (K, M, D)
    tilde = tilde.transpose(0, 2, 1)                       # (K, D, M)
    rate = (hp.nu_1 + tilde[:, None, :, :] * state.xi**2) / 2.0
    shape = (hp.nu_1 + 1.0) / 2.0
    g = jax.random.gamma(key, jnp.full(rate.shape, shape))
    return state.replace(gamma_xi=g / rate)


# ---------------------------------------------------------------------------
# A — MGP hyperparameters (truncated-normal MH, vectorized over features)
# Reference: updateA / lpdf_a1 / lpdf_a2 (UpdateA.h:17-123).
# ---------------------------------------------------------------------------

def _lpdf_a1(a, delta0, hp):
    return (-gammaln(a) + (a - 1.0) * jnp.log(delta0)
            + (hp.alpha1l - 1.0) * jnp.log(a) - a * hp.beta1l)


def _lpdf_a2(a, delta_tail_logsum, M_minus_1, hp):
    return (-M_minus_1 * gammaln(a) + (hp.alpha2l - 1.0) * jnp.log(a)
            - a * hp.beta2l + (a - 1.0) * delta_tail_logsum)


def _mh_truncnorm(key, a_cur, sd, lpdf):
    kp, ka = jax.random.split(key)
    a_new = truncnorm_sample(kp, a_cur, sd)
    log_acc = (lpdf(a_new) + truncnorm_logpdf(a_cur, a_new, sd)
               - lpdf(a_cur) - truncnorm_logpdf(a_new, a_cur, sd))
    u = jax.random.uniform(ka, a_cur.shape)
    accept = jnp.where(jnp.isnan(log_acc), False, jnp.log(u) < log_acc)
    return jnp.where(accept, a_new, a_cur)


def update_a(key, state, hp):
    M = state.delta.shape[1]
    k1, k2 = jax.random.split(key)
    a1 = _mh_truncnorm(
        k1, state.A[:, 0], hp.var_epsilon1 / hp.beta1l,
        lambda a: _lpdf_a1(a, state.delta[:, 0], hp))
    tail = jnp.sum(jnp.log(state.delta[:, 1:]), axis=1)
    a2 = _mh_truncnorm(
        k2, state.A[:, 1], hp.var_epsilon2 / hp.beta2l,
        lambda a: _lpdf_a2(a, tail, M - 1.0, hp))
    return state.replace(A=jnp.stack([a1, a2], axis=1))


def update_a_xi(key, state, hp):
    """Reference: updateAXi (UpdateA.h:137-205); vectorized over (K, D)."""
    if state.A_xi.shape[2] == 0:
        return state
    M = state.delta_xi.shape[1]
    k1, k2 = jax.random.split(key)
    a1 = _mh_truncnorm(
        k1, state.A_xi[:, 0, :], hp.var_epsilon1 / hp.beta1l,
        lambda a: _lpdf_a1(a, state.delta_xi[:, 0, :], hp))
    tail = jnp.sum(jnp.log(state.delta_xi[:, 1:, :]), axis=1)  # (K, D)
    a2 = _mh_truncnorm(
        k2, state.A_xi[:, 1, :], hp.var_epsilon2 / hp.beta2l,
        lambda a: _lpdf_a2(a, tail, M - 1.0, hp))
    return state.replace(A_xi=jnp.stack([a1, a2], axis=1))


# ---------------------------------------------------------------------------
# Gauge moves — MH along the model's exact likelihood-invariances.
#
# NOT a reference kernel.  The mixed membership mean
#     mu_n = B_n sum_k Z_nk (nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n)
# is EXACTLY invariant under two transformation families:
#
#   (a) feature mixing: for a feature pair (a, b) and T = I + c G with
#       G = e_a (e_b - e_a)' and c = 1 - exp(-eps),
#         (nu, Phi, eta, xi) <- T ·_featureaxis (...),   Z <- Z T^{-1};
#       rows of Z stay on the simplex (T 1 = 1).  This is the in-sampler
#       form of the reference's post-hoc "rescale" identifiability
#       transform (PostProcessing.cpp:203-220) — the convex-hull gauge.
#   (b) eigen rescale: chi[:, m] <- chi/s, (Phi, xi)[..., m] <- s * (...).
#   (c) eigen ROTATION: for any orthogonal R (M x M),
#         chi <- chi R,  Phi_k <- Phi_k R,  xi_kd <- xi_kd R;
#       every mean term U_n chi_n = (U_n R)(R' chi_n) is untouched.  The
#       chi prior N(0, I_M) is rotation-invariant and all three blockwise
#       Jacobians are +/-1, so acceptance reduces to the MGP prior terms
#       of Phi (and xi) alone — the direction neither (a) nor (b) covers
#       (round-3 VERDICT #2a: the loglik/fit-quality ridge lives in the
#       eigen-subspace orientation, which only a rotation can slide).
#
# The posterior is NOT invariant (priors and Jacobians break the symmetry),
# so these directions form a near-flat ridge that the conditional kernels
# random-walk across on an O(10^4)-sweep timescale (measured: cross-chain
# R-hat on boundary fitted values plateaus ~1.4-1.7; BENCH_SUITE.md).  An
# MH proposal that moves ALONG the invariance costs O(K P (M + D(1+M)))
# FLOPs — no likelihood evaluation — and mixes the ridge directly.
#
# Acceptance: log a = [log prior(new) - log prior(old)] + log|J|, with
#   (a) log|J| = eps * (N - P(1 + M + D + D*M))   (det T = e^{-eps}; the
#       Z rows' simplex-restricted Jacobian is e^{eps} per row)
#   (b) log|J| = (K*P*(1 + D) - N) * log s
# Both moves leave every likelihood factor untouched, so beta-tempering
# does not enter.  Exactness is covered by the Geweke joint-invariance test
# of the production sweep (tests/test_geweke_covadj.py::
# test_geweke_collapsed_gauge_sweep).
# ---------------------------------------------------------------------------

def _gauge_logprior(state, data, hp):
    """Prior terms that gauge maps can change (log scale, constants fixed)."""
    lp = jnp.sum((state.alpha3 * state.pi - 1.0) * jnp.log(state.Z))
    quad_nu = jnp.einsum("kp,pq,kq->k", state.nu, data.pen, state.nu, **_HI)
    lp = lp - 0.5 * jnp.sum(state.tau * quad_nu)
    tilde = jnp.cumprod(state.delta, axis=1)               # (K, M)
    lp = lp - 0.5 * jnp.sum(tilde[:, None, :] * state.gamma * state.Phi ** 2)
    lp = lp - 0.5 * jnp.sum(state.chi ** 2)
    if data.D > 0:
        quad_eta = jnp.einsum("kpd,pq,kqd->kd", state.eta, data.pen,
                              state.eta, **_HI)
        lp = lp - 0.5 * jnp.sum(state.tau_eta * quad_eta)
        tilde_xi = jnp.cumprod(state.delta_xi, axis=1)     # (K, M, D)
        pri = tilde_xi.transpose(0, 2, 1)[:, None, :, :]   # (K, 1, D, M)
        lp = lp - 0.5 * jnp.sum(pri * state.gamma_xi * state.xi ** 2)
    return lp


def _mix_features(state, data, ea, eb, eps):
    """Apply the T = I + (1-e^{-eps}) e_a (e_b - e_a)' gauge map."""
    c = 1.0 - jnp.exp(-eps)
    cp = 1.0 - jnp.exp(eps)

    def rowmap(x):       # x: (K, ...) feature-indexed
        xa = jnp.tensordot(ea, x, axes=1)
        xb = jnp.tensordot(eb, x, axes=1)
        shape = (-1,) + (1,) * (x.ndim - 1)
        return x + ea.reshape(shape) * (c * (xb - xa))[None]

    za = jnp.dot(state.Z, ea, **_HI)                     # (N,)
    Z = state.Z + cp * za[:, None] * (eb - ea)[None, :]
    new = dict(Z=Z, nu=rowmap(state.nu), Phi=rowmap(state.Phi))
    if data.D > 0:
        new["eta"] = rowmap(state.eta)
        new["xi"] = rowmap(state.xi)
    return state.replace(**new)


def _rescale_eigen(state, data, em, log_s):
    """Apply the chi/Phi eigen-rescale gauge map for component mask em."""
    s = jnp.exp(log_s)
    scale_m = 1.0 + (s - 1.0) * em                       # (M,)
    chi = state.chi / scale_m[None, :]
    Phi = state.Phi * scale_m[None, None, :]
    new = dict(chi=chi, Phi=Phi)
    if data.D > 0:
        new["xi"] = state.xi * scale_m[None, None, None, :]
    return state.replace(**new)


def _rotate_eigen(state, data, m1, m2, theta):
    """Apply the Givens rotation of eigen-columns (m1, m2) by theta to
    (chi, Phi[, xi]) — the exact likelihood invariance (c) above."""
    dt = state.chi.dtype
    M = state.M
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    e1 = jax.nn.one_hot(m1, M, dtype=dt)
    e2 = jax.nn.one_hot(m2, M, dtype=dt)
    R = (jnp.eye(M, dtype=dt)
         + (c - 1.0) * (jnp.outer(e1, e1) + jnp.outer(e2, e2))
         + s * (jnp.outer(e2, e1) - jnp.outer(e1, e2)))
    new = dict(chi=jnp.dot(state.chi, R, **_HI),
               Phi=jnp.einsum("kpm,ml->kpl", state.Phi, R, **_HI))
    if data.D > 0:
        new["xi"] = jnp.einsum("kpdm,ml->kpdl", state.xi, R, **_HI)
    return state.replace(**new)


def update_gauge(key, state, data, hp, *, sigma_mix=0.3, sigma_scale=0.3,
                 sigma_rotate=0.5, n_mix=1, n_scale=1, n_rotate=1):
    """Gauge MH moves: ``n_mix`` random feature-pair mixing proposals,
    ``n_scale`` random eigen-index rescale proposals, and ``n_rotate``
    random eigen-pair Givens-rotation proposals per call.

    One move of each kind per sweep suffices — the gauge subspace is only
    K(K-1)+M+M(M-1)/2 dimensional and each accepted move is a macroscopic
    slide along it, so its mixing time is decoupled from the conditional
    sweep's; keeping the count at 1 keeps the kernel's latency cost ~3
    small fused blocks instead of one per gauge dimension."""
    K, M = state.K, state.M
    P = state.nu.shape[1]
    D = data.D
    eyeK = jnp.eye(K, dtype=state.nu.dtype)
    eyeM = jnp.eye(M, dtype=state.nu.dtype)
    jac_mix = data.N - P * (1.0 + M + D + D * M)
    jac_scale = K * P * (1.0 + D) - data.N

    def mix_body(i, carry):
        st, lp = carry
        ki = jax.random.fold_in(key, i)
        kab, ke, ku = jax.random.split(ki, 3)
        idx = jax.random.randint(kab, (), 0, K * (K - 1))
        a = idx // (K - 1)
        rem = idx % (K - 1)
        b = jnp.where(rem >= a, rem + 1, rem)
        eps = sigma_mix * jax.random.normal(ke, dtype=state.nu.dtype)
        prop = _mix_features(st, data, eyeK[a], eyeK[b], eps)
        lp_new = _gauge_logprior(prop, data, hp)
        log_acc = lp_new - lp + eps * jac_mix
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        st = jax.tree.map(lambda n, o: jnp.where(ok, n, o), prop, st)
        lp = jnp.where(ok, lp_new, lp)
        return st, lp

    def scale_body(i, carry):
        st, lp = carry
        ki = jax.random.fold_in(key, 7907 + i)
        km, ke, ku = jax.random.split(ki, 3)
        m = jax.random.randint(km, (), 0, M)
        log_s = sigma_scale * jax.random.normal(ke, dtype=state.nu.dtype)
        prop = _rescale_eigen(st, data, eyeM[m], log_s)
        lp_new = _gauge_logprior(prop, data, hp)
        log_acc = lp_new - lp + log_s * jac_scale
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        st = jax.tree.map(lambda n, o: jnp.where(ok, n, o), prop, st)
        lp = jnp.where(ok, lp_new, lp)
        return st, lp

    def rotate_body(i, carry):
        # Givens rotation of a random ordered eigen-pair; theta ~ N(0, s^2)
        # is a symmetric proposal and all Jacobians are unity, so the MH
        # ratio is the prior ratio alone (invariance (c) above).
        st, lp = carry
        ki = jax.random.fold_in(key, 15485863 + i)
        km, ke, ku = jax.random.split(ki, 3)
        idx = jax.random.randint(km, (), 0, M * (M - 1))
        m1 = idx // (M - 1)
        rem = idx % (M - 1)
        m2 = jnp.where(rem >= m1, rem + 1, rem)
        theta = sigma_rotate * jax.random.normal(ke, dtype=state.nu.dtype)
        prop = _rotate_eigen(st, data, m1, m2, theta)
        lp_new = _gauge_logprior(prop, data, hp)
        log_acc = lp_new - lp
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        st = jax.tree.map(lambda n, o: jnp.where(ok, n, o), prop, st)
        lp = jnp.where(ok, lp_new, lp)
        return st, lp

    lp0 = _gauge_logprior(state, data, hp)
    state, lp = jax.lax.fori_loop(0, n_mix, mix_body, (state, lp0),
                                  unroll=_unroll(n_mix))
    state, lp = jax.lax.fori_loop(0, n_scale, scale_body, (state, lp),
                                  unroll=_unroll(n_scale))
    if M >= 2:
        state, _ = jax.lax.fori_loop(0, n_rotate, rotate_body, (state, lp),
                                     unroll=_unroll(n_rotate))
    return state




# ---------------------------------------------------------------------------
# MGP scale interweaving — ASIS move along the hierarchy's funnel direction.
#
# NOT a reference kernel.  Round-4 basin diagnosis (BENCH_SUITE.md §4.1):
# after the Z multimodality is handled, the slowest posterior direction is
# a continuous (sigma2, Phi-scale, MGP-precision) drift — chains carry ~2%
# sigma2 offsets coupled to Phi column norms 1.7 vs 2.4 with an integrated
# autocorrelation of thousands of sweeps.  That is the classic centered-
# parameterization funnel of scale hierarchies: the centered Gibbs tower
# (delta | Phi conjugate, Phi | delta Gibbs) random-walks the joint scale.
#
# The ancillary-sufficiency (ASIS / interweaving, Yu & Meng 2011) fix: an
# MH move in the NON-CENTERED coordinates Phi_raw = Phi * sqrt(tilde_tau *
# gamma).  Proposing delta_{k,i} -> delta_{k,i} e^eps with Phi_raw HELD
# FIXED rescales Phi columns m >= i of feature k by e^{-eps/2} — one
# coordinated slide along the funnel.  In these coordinates the Gaussian
# Phi-prior normalization (+eps/2 per affected entry) cancels the Phi
# Jacobian (-eps/2 per entry) exactly, leaving
#
#   log a = beta * dloglik + (a_i - 1) eps - delta_ki (e^eps - 1) + eps
#
# with a_i the MGP Gamma shape (A[k,0] if i==0 else A[k,1], unit rate) and
# the final +eps the log-delta proposal Jacobian.  dloglik is evaluated in
# residual space (f32-stable, ops/mean.py rationale) from the cache's
# effective coefficients.  Exactness is covered by the production-sweep
# Geweke joint-invariance test (tests/test_geweke_covadj.py).
# ---------------------------------------------------------------------------

def update_mgp_scale(key, state, data, hp, cache: SweepCache, beta=1.0, *,
                     sigma_eps=0.03, n_moves=4):
    """``n_moves`` random (feature, column) interweaved MGP-scale moves.

    sigma_eps tuning (measured on the equilibrated 256-chain headline
    ensemble): mean MH acceptance 0.029 at eps-sd 0.4, 0.22 at 0.05,
    0.42 at 0.02 — the scale-conditional sd is ~0.02, so the default
    0.03 / 4 moves per sweep diffuses across the measured ~2% per-chain
    sigma2 offsets in O(10^2) sweeps instead of the centered tower's
    O(10^4) random walk."""
    K, P, M = state.Phi.shape
    m_idx = jnp.arange(M)
    dt = state.Phi.dtype

    def rss_pair(w0, w1):
        w2 = jnp.stack([w0, w1])
        if data.identity_basis:
            r = data.y[None] - w2
        else:
            r = data.y[None] - jnp.einsum("nlp,enp->enl", data.B, w2, **_HI)
        return jnp.sum(r * r, axis=(1, 2))

    def body(i, carry):
        st, w = carry
        ki = jax.random.fold_in(key, 7829 + i)
        kk, ke, ku = jax.random.split(ki, 3)
        idx = jax.random.randint(kk, (), 0, K * M)
        kf = idx // M
        col = idx % M
        eps = sigma_eps * jax.random.normal(ke, dtype=dt)
        fmask = jax.nn.one_hot(kf, K, dtype=dt)                 # (K,)
        cmask = (m_idx >= col).astype(dt)                       # (M,)
        smul = 1.0 + (jnp.exp(-eps / 2.0) - 1.0) \
            * fmask[:, None, None] * cmask[None, None, :]       # (K,1,M)
        Phi_new = st.Phi * smul
        dw = jnp.einsum("nk,kpm,nm->np", st.Z, Phi_new - st.Phi,
                        st.chi, **_HI)
        rss2 = rss_pair(w, w + dw)
        dll = -beta * (rss2[1] - rss2[0]) / (2.0 * st.sigma2)
        a_i = jnp.where(col == 0, st.A[kf, 0], st.A[kf, 1])
        d_ki = st.delta[kf, col]
        log_acc = dll + (a_i - 1.0) * eps - d_ki * (jnp.exp(eps) - 1.0) + eps
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        dmul = 1.0 + (jnp.exp(eps) - 1.0) * fmask[:, None] \
            * jax.nn.one_hot(col, M, dtype=dt)[None, :]
        st = st.replace(
            Phi=jnp.where(ok, Phi_new, st.Phi),
            delta=jnp.where(ok, st.delta * dmul, st.delta))
        w = jnp.where(ok, w + dw, w)
        return st, w

    state, w = jax.lax.fori_loop(0, n_moves, body, (state, cache.w),
                                 unroll=_unroll(n_moves))
    return state, cache.replace(w=w)


# ---------------------------------------------------------------------------
# Noise/eigen-scale interweaving — joint (sigma2, delta, Phi[, xi]) slide.
#
# NOT a reference kernel.  Round-4 measurement (BENCH_SUITE.md §4.1): the
# residual cross-chain R-hat on the log-likelihood is a slow continuous
# drift of per-chain sigma2 offsets (~2%) COUPLED to Phi column norms
# (1.7 vs 2.4 best-vs-worst chain) — and no kernel moved sigma2 jointly
# with the scale coordinates it is correlated with (round-4 verdict).  The
# update_mgp_scale interweave above slides (delta, Phi) only.
#
# This kernel proposes the 1-D scale family along that measured axis,
# eps ~ N(0, sigma_eps^2):
#
#     sigma2 -> sigma2 e^eps          Phi -> Phi e^{eps/2}
#     delta[:, 0] -> delta[:, 0] e^{-eps}        (so tilde_tau -> e^{-eps})
#     [xi -> xi e^{eps/2},  delta_xi[:, 0, :] -> e^{-eps} likewise]
#
# holding (Z, chi, nu, eta, gamma, A) fixed.  As in update_mgp_scale the
# non-centered coordinates Phi*sqrt(tilde_tau*gamma) are HELD FIXED: the
# Gaussian Phi/xi prior normalization (-eps/2 per entry) cancels the
# Phi/xi map Jacobian (+eps/2 per entry) exactly, leaving
#
#   log a = beta*dloglik
#           - alpha_0*eps - (beta_0/sigma2)(e^{-eps}-1)        [sigma2 IG
#                                                + its +eps Jacobian]
#           - eps*sum_k A[k,0] - (e^{-eps}-1)*sum_k delta[k,0] [delta Gamma
#                                                + its -eps/k Jacobian]
#           [- the same two terms over (k,d) for delta_xi]
#
#   dloglik = -n_tot*eps/2 - (RSS(s e^{eps/2}) e^{-eps} - RSS(s))/(2 sigma2)
#
# Because the move only rescales the eigen contribution e_n = B_n U_n chi_n
# of the fitted mean (U from Phi and xi both), RSS at cumulative scale s
# collapses to the scalar quadratic  RSS(s) = rr0 - 2 s re + s^2 ee  with
# rr0 = ||y - B a||^2, ee = ||e||^2, re = <y - B a, e> materialized ONCE in
# residual space (f32-stable, ops/mean.py rationale) — so n_moves chained
# MH proposals cost pure scalar math.  Exactness is covered by the
# production-sweep Geweke joint-invariance test (tests/test_geweke_covadj
# .py::test_geweke_collapsed_gauge_sweep).  Reference anchors: the sigma2
# conditional this interweaves with (UpdateSigma.h:22-58) and the MGP tower
# it re-coordinates (UpdateDelta.h:17-64, UpdatePhi.h:76-78).
# ---------------------------------------------------------------------------

def _noise_scale_log_acc(eps, s, sig2, d0, d0xi, rss_coeffs, n_tot, sumA,
                         hp, beta):
    """Closed-form MH log-acceptance of one noise/eigen-scale slide at
    cumulative eigen scale ``s`` (derivation in the block comment above;
    verified against a brute-force posterior-ratio + Jacobian computation
    in tests/test_collapsed_gauge.py)."""
    rr0, re, ee = rss_coeffs

    def rss(sc):
        return rr0 - 2.0 * sc * re + sc * sc * ee

    em = jnp.exp(-eps)
    dll = -beta * (n_tot * eps / 2.0
                   + (rss(s * jnp.exp(eps / 2.0)) * em - rss(s))
                   / (2.0 * sig2))
    return (dll - hp.alpha_0 * eps - hp.beta_0 / sig2 * (em - 1.0)
            - sumA * eps - (em - 1.0) * (d0 + d0xi))


def update_noise_scale(key, state, data, hp, cache: SweepCache, beta=1.0, *,
                       sigma_eps=0.015, n_moves=8):
    """``n_moves`` chained joint (sigma2, MGP/eigen-scale) slide moves.

    The usable step is set by the likelihood curvature along the family,
    ~ (n_tot + ee/sigma2)^{-1/2} ~ 0.01 at the headline scale (n_tot =
    1e4); n_moves is nearly free (scalar chain after two length-L
    einsums), so the kernel diffuses across the measured ~2% per-chain
    sigma2 offsets in O(10^1-10^2) sweeps."""
    D = data.D
    dt = state.Phi.dtype
    # eigen contribution (the part the move rescales) and its complement
    U = eigen_directions(state, data.X)                      # (N, P, M)
    ec = jnp.einsum("npm,nm->np", U, state.chi, **_HI)       # (N, P)
    ac = cache.w - ec
    if data.identity_basis:
        r0 = data.y - ac
        e = ec
    else:
        r0 = data.y - jnp.einsum("nlp,np->nl", data.B, ac, **_HI)
        e = jnp.einsum("nlp,np->nl", data.B, ec, **_HI)
    rr0 = jnp.sum(r0 * r0)
    ee = jnp.sum(e * e)
    re = jnp.sum(r0 * e)
    n_tot = data.n_obs_total
    sumA = jnp.sum(state.A[:, 0])
    sum_d0 = jnp.sum(state.delta[:, 0])
    if D > 0:
        sumA = sumA + jnp.sum(state.A_xi[:, 0, :])
        sum_d0_xi = jnp.sum(state.delta_xi[:, 0, :])
    else:
        sum_d0_xi = jnp.zeros((), dt)

    def body(i, carry):
        s, sig2, d0, d0xi = carry
        ki = jax.random.fold_in(key, 104729 + i)
        ke, ku = jax.random.split(ki)
        eps = sigma_eps * jax.random.normal(ke, dtype=dt)
        log_acc = _noise_scale_log_acc(
            eps, s, sig2, d0, d0xi, (rr0, re, ee), n_tot, sumA, hp, beta)
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        gr = jnp.where(ok, jnp.exp(eps), 1.0)
        return (s * jnp.sqrt(gr), sig2 * gr, d0 / gr, d0xi / gr)

    s, sig2, d0, d0xi = jax.lax.fori_loop(
        0, n_moves, body,
        (jnp.ones((), dt), state.sigma2, sum_d0, sum_d0_xi),
        unroll=_unroll(n_moves))
    new = dict(sigma2=sig2,
               Phi=state.Phi * s,
               delta=state.delta.at[:, 0].mul(1.0 / (s * s)))
    if D > 0:
        new["xi"] = state.xi * s
        new["delta_xi"] = state.delta_xi.at[:, 0, :].mul(1.0 / (s * s))
    return state.replace(**new), cache.replace(w=ac + s * ec)


# ---------------------------------------------------------------------------
# Collapsed (Phi, chi) update — MH on Phi under the CHI-MARGINAL likelihood.
#
# NOT a reference kernel.  Round-5 diagnosis (benchmarks/fit_spread_diag.py
# on the equilibrated 256-chain ensemble): the residual cross-chain R-hat
# direction is pure FIT QUALITY — the profile log-likelihood (sigma2
# profiled out) carries 26.8 of the 26.9-unit between-chain loglik sd
# (corr 0.998), with cross-chain RSS offsets of ~0.5% persisting for
# thousands of sweeps; the sigma2/MGP-scale couplings round 4 diagnosed
# are slaved symptoms (moving them measurably does NOT shrink the spread —
# benchmarks/noise_scale_probe.py trajectory).
#
# Mechanism: Phi and chi form a bilinear pair.  The exact conditional
# Phi | chi (update_phi) has precision ~ (beta/sigma2) sum_n chi^2 G_n —
# extremely tight at high SNR — while the chi-MARGINAL posterior of Phi
# (the "Bayesian PCA" posterior of the eigen structure, width ~ 1/sqrt(N))
# is far broader.  Alternating two tight conditionals random-walks the
# marginal with steps of conditional width: mixing time ~ (marginal/
# conditional width)^2 ~ thousands of sweeps — exactly the measured tau.
# The same coupling pathology motivated the collapsed (Z, chi) kernel
# (update_z_chi); this kernel applies the identical partially-collapsed
# pattern (Van Dyk & Park 2008) to Phi:
#
#   1. MH moves on single Phi columns (k, m) under the chi-marginal
#      likelihood  y_n | Phi ~ N(B_n a_n, (sigma2/beta) I + F_n F_n'),
#      F_n = B_n U_n  (the CPO marginal, CalculateLikelihood.h:361-372),
#      evaluated in M-space via C_n = I + s U_n' G_n U_n exactly as
#      update_z_chi does, with the MGP prior term for the column;
#   2. one exact joint redraw of ALL chi rows given the final Phi.
#
# Nothing reads the stale chi in between, so the composition leaves the
# joint invariant; the proof rides the production-sweep Geweke test
# (tests/test_geweke_covadj.py::test_geweke_collapsed_gauge_sweep).
# ---------------------------------------------------------------------------

def update_phi_chi(key, state, data, hp, cache: SweepCache, beta=1.0, *,
                   sigma_rw=0.1, n_moves=6):
    """``n_moves`` chi-marginal MH column moves on Phi + joint chi redraw.

    Proposal: uniform column (k, m); step N(0, sigma_rw^2 * col_scale^2 I)
    with col_scale = (||Phi_k[:, m]|| + 0.1)/sqrt(N) — the marginal
    posterior width of an eigen column scales like its norm over sqrt(N)
    observations, so one tuning constant serves every shrinkage level.
    The scale depends on the (changing) column norm, so the proposal is
    not symmetric; the Hastings ratio evaluates both directions' Gaussian
    densities explicitly.
    """
    K, P, M = state.Phi.shape
    N = data.N
    s = beta / state.sigma2
    dt = state.Phi.dtype
    tilde_tau = jnp.cumprod(state.delta, axis=1)              # (K, M)

    # Phi-independent precomputes: mean-only residual pieces
    a = _mean_only_offsets(state, data.X)                     # (N, K, P)
    a = jnp.einsum("nk,nkp->np", state.Z, a, **_HI)           # (N, P)
    if data.identity_basis:
        r0 = data.y - a
        ur = data.u - a
    else:
        r0 = data.y - jnp.einsum("nlp,np->nl", data.B, a, **_HI)
        ur = data.u - jnp.einsum("npq,nq->np", data.G, a, **_HI)
    rr0 = jnp.sum(r0 * r0, axis=-1)                           # (N,)
    sum_rr0 = jnp.sum(rr0)

    # U/GU carried as per-column tuples: no trailing-(M, M) or (P, M)
    # tensor is ever materialized inside the move loop (the entries-
    # interface rationale, ops/linalg.py)
    U0 = eigen_directions(state, data.X)                      # (N, P, M)
    Ul0 = tuple(U0[:, :, m] for m in range(M))
    if data.identity_basis:
        GUl0 = Ul0
    else:
        GUl0 = tuple(jnp.einsum("npq,nq->np", data.G, u, **_HI)
                     for u in Ul0)

    def marg_ll(Ul, GUl):
        """Total chi-marginal log-likelihood from per-column U entries."""
        C = [[(1.0 if i == j else 0.0)
              + s * jnp.einsum("np,np->n", Ul[i], GUl[j], **_HI)
              for j in range(i + 1)] for i in range(M)]
        Lc = small_chol_entries(C)
        Fr = [jnp.einsum("np,np->n", Ul[m], ur, **_HI) for m in range(M)]
        wv = small_solve_lower_entries(Lc, Fr)
        quad = sum(jnp.sum(v * v) for v in wv)
        return -0.5 * (jnp.sum(small_logdet_entries(Lc))
                       + s * sum_rr0 - s * s * quad)

    def col_scale(Phi, k, m):
        col = jax.lax.dynamic_slice(
            Phi, (k, 0, m), (1, P, 1))[0, :, 0]
        return (jnp.linalg.norm(col) + 0.1) / jnp.sqrt(
            jnp.asarray(N, dt)), col

    def body(i, carry):
        Phi, Ul, GUl, ll = carry
        ki = jax.random.fold_in(key, 86028121 + i)
        kk, ke, ku = jax.random.split(ki, 3)
        idx = jax.random.randint(kk, (), 0, K * M)
        k = idx // M
        m = idx % M
        sc, col = col_scale(Phi, k, m)
        step = sigma_rw * sc * jax.random.normal(ke, (P,), dt)
        col_new = col + step
        # Hastings for the norm-adaptive scale (reverse uses new norm)
        sc_new, _ = col_scale(
            jax.lax.dynamic_update_slice(Phi, col_new[None, :, None],
                                         (k, 0, m)), k, m)
        lq_fwd = -P * jnp.log(sc) \
            - jnp.sum(step * step) / (2.0 * (sigma_rw * sc) ** 2)
        lq_bwd = -P * jnp.log(sc_new) \
            - jnp.sum(step * step) / (2.0 * (sigma_rw * sc_new) ** 2)
        zk = state.Z[:, k]
        dU = zk[:, None] * step[None, :]                       # (N, P)
        dGU = dU if data.identity_basis \
            else jnp.einsum("npq,nq->np", data.G, dU, **_HI)
        Ul_new = tuple(jnp.where(m == j, u + dU, u)
                       for j, u in enumerate(Ul))
        GUl_new = Ul_new if data.identity_basis \
            else tuple(jnp.where(m == j, g + dGU, g)
                       for j, g in enumerate(GUl))
        ll_new = marg_ll(Ul_new, GUl_new)
        pri = tilde_tau[k, m] * jax.lax.dynamic_slice(
            state.gamma, (k, 0, m), (1, P, 1))[0, :, 0]
        dpri = -0.5 * jnp.sum(pri * (col_new ** 2 - col ** 2))
        log_acc = ll_new - ll + dpri + lq_bwd - lq_fwd
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        Phi = jnp.where(ok, jax.lax.dynamic_update_slice(
            Phi, col_new[None, :, None], (k, 0, m)), Phi)
        Ul = tuple(jnp.where(ok, n_, o_) for n_, o_ in zip(Ul_new, Ul))
        if not data.identity_basis:
            GUl = tuple(jnp.where(ok, n_, o_)
                        for n_, o_ in zip(GUl_new, GUl))
        else:
            GUl = Ul
        ll = jnp.where(ok, ll_new, ll)
        return Phi, Ul, GUl, ll

    Phi, Ul, GUl, _ = jax.lax.fori_loop(
        0, n_moves, body, (state.Phi, Ul0, GUl0, marg_ll(Ul0, GUl0)),
        unroll=_unroll(n_moves))

    # exact joint chi | Phi redraw (entries form, update_chi_joint pattern)
    kc = jax.random.fold_in(key, 179424673)
    C = [[(1.0 if i == j else 0.0)
          + s * jnp.einsum("np,np->n", Ul[i], GUl[j], **_HI)
          for j in range(i + 1)] for i in range(M)]
    Lc = small_chol_entries(C)
    b = [s * jnp.einsum("np,np->n", Ul[m], ur, **_HI) for m in range(M)]
    z = jax.random.normal(kc, (M, N), dt)
    mean = small_solve_upper_t_entries(Lc, small_solve_lower_entries(Lc, b))
    noise = small_solve_upper_t_entries(Lc, [z[m] for m in range(M)])
    chi_cols = [mean[m] + noise[m] for m in range(M)]
    w = a
    for m in range(M):
        w = w + chi_cols[m][:, None] * Ul[m]
    chi = jnp.stack(chi_cols, axis=-1)
    return state.replace(Phi=Phi, chi=chi), cache.replace(w=w)


def update_phi_mala(key, state, data, hp, cache: SweepCache, beta=1.0, *,
                    step=0.05, n_steps=4):
    """Preconditioned MALA on the WHOLE Phi under the chi-marginal target,
    then one exact joint chi redraw — the gradient-based big sibling of
    update_phi_chi's column moves.

    One gradient evaluation moves all K*P*M coordinates at once; with the
    optimal-scaling step ~ dim^{-1/6} the expected squared jump per
    marginal evaluation is an order of magnitude above the column
    random walk's, which is what the measured ~10^3-sweep fit-level
    autocorrelation needs (BENCH_SUITE.md round-5 study).  Preconditioner:
    diagonal, per-column scale (||Phi_k[:, m]|| + 0.1)/sqrt(N), FROZEN at
    kernel entry (each internal step uses the same fixed scale in both
    proposal densities, so every step is a valid MH move and the
    composition is invariant).  The joint-invariance proof rides the
    production-sweep Geweke test when wired in via ``phi_mala_steps``.
    """
    K, P, M = state.Phi.shape
    N = data.N
    s = beta / state.sigma2
    dt = state.Phi.dtype
    tilde_tau = jnp.cumprod(state.delta, axis=1)              # (K, M)
    pri = tilde_tau[:, None, :] * state.gamma                 # (K, P, M)

    a = _mean_only_offsets(state, data.X)
    a = jnp.einsum("nk,nkp->np", state.Z, a, **_HI)           # (N, P)
    if data.identity_basis:
        r0 = data.y - a
        ur = data.u - a
    else:
        r0 = data.y - jnp.einsum("nlp,np->nl", data.B, a, **_HI)
        ur = data.u - jnp.einsum("npq,nq->np", data.G, a, **_HI)
    sum_rr0 = jnp.sum(r0 * r0)

    def potential(Phi):
        """-(beta-tempered chi-marginal loglik + MGP log prior), entries
        form (no trailing-(M, M) tensor; ops/linalg.py rationale)."""
        if data.X.shape[1] > 0:
            Vl = [Phi[None, :, :, m]
                  + jnp.einsum("kpd,nd->nkp", state.xi[:, :, :, m],
                               data.X, **_HI) for m in range(M)]
            Ul = [jnp.einsum("nk,nkp->np", state.Z, V, **_HI) for V in Vl]
        else:
            Ul = [jnp.einsum("nk,kp->np", state.Z, Phi[:, :, m], **_HI)
                  for m in range(M)]
        GUl = Ul if data.identity_basis else \
            [jnp.einsum("npq,nq->np", data.G, u, **_HI) for u in Ul]
        C = [[(1.0 if i == j else 0.0)
              + s * jnp.einsum("np,np->n", Ul[i], GUl[j], **_HI)
              for j in range(i + 1)] for i in range(M)]
        Lc = small_chol_entries(C)
        Fr = [jnp.einsum("np,np->n", Ul[m], ur, **_HI) for m in range(M)]
        wv = small_solve_lower_entries(Lc, Fr)
        quad = sum(jnp.sum(v * v) for v in wv)
        ll = -0.5 * (jnp.sum(small_logdet_entries(Lc))
                     + s * sum_rr0 - s * s * quad)
        return -(ll - 0.5 * jnp.sum(pri * Phi * Phi))

    pot_grad = jax.value_and_grad(potential)

    # frozen diagonal preconditioner: per-column marginal width scale
    w_col = (jnp.sqrt(jnp.sum(state.Phi ** 2, axis=1)) + 0.1) \
        / jnp.sqrt(jnp.asarray(N, dt))                        # (K, M)
    W = jnp.broadcast_to(w_col[:, None, :], (K, P, M))
    V = W * W
    e2 = step * step

    def body(i, carry):
        x, pot, grad = carry
        ki = jax.random.fold_in(key, 53916731 + i)
        ke, ku = jax.random.split(ki)
        xi = jax.random.normal(ke, x.shape, dt)
        mean_f = x - 0.5 * e2 * V * grad
        x_new = mean_f + step * W * xi
        pot_new, grad_new = pot_grad(x_new)
        lq_fwd = -0.5 * jnp.sum(xi * xi)
        mean_b = x_new - 0.5 * e2 * V * grad_new
        db = x - mean_b
        lq_bwd = -jnp.sum(db * db / V) / (2.0 * e2)
        log_acc = pot - pot_new + lq_bwd - lq_fwd
        ok = jnp.log(jax.random.uniform(ku)) < jnp.nan_to_num(
            log_acc, nan=-jnp.inf)
        x = jnp.where(ok, x_new, x)
        pot = jnp.where(ok, pot_new, pot)
        grad = jnp.where(ok, grad_new, grad)
        return x, pot, grad

    pot0, grad0 = pot_grad(state.Phi)
    Phi, _, _ = jax.lax.fori_loop(0, n_steps, body,
                                  (state.Phi, pot0, grad0),
                                  unroll=_unroll(n_steps))

    # exact joint chi | Phi redraw (entries form)
    if data.X.shape[1] > 0:
        Vl = [Phi[None, :, :, m]
              + jnp.einsum("kpd,nd->nkp", state.xi[:, :, :, m],
                           data.X, **_HI) for m in range(M)]
        Ul = [jnp.einsum("nk,nkp->np", state.Z, V, **_HI) for V in Vl]
    else:
        Ul = [jnp.einsum("nk,kp->np", state.Z, Phi[:, :, m], **_HI)
              for m in range(M)]
    GUl = Ul if data.identity_basis else \
        [jnp.einsum("npq,nq->np", data.G, u, **_HI) for u in Ul]
    C = [[(1.0 if i == j else 0.0)
          + s * jnp.einsum("np,np->n", Ul[i], GUl[j], **_HI)
          for j in range(i + 1)] for i in range(M)]
    Lc = small_chol_entries(C)
    b = [s * jnp.einsum("np,np->n", Ul[m], ur, **_HI) for m in range(M)]
    z = jax.random.normal(jax.random.fold_in(key, 15487469), (M, N), dt)
    mean = small_solve_upper_t_entries(Lc, small_solve_lower_entries(Lc, b))
    noise = small_solve_upper_t_entries(Lc, [z[m] for m in range(M)])
    chi_cols = [mean[m] + noise[m] for m in range(M)]
    w = a
    for m in range(M):
        w = w + chi_cols[m][:, None] * Ul[m]
    chi = jnp.stack(chi_cols, axis=-1)
    return state.replace(Phi=Phi, chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# Whole-model HMC hybrid step (round 5) — one Metropolis-adjusted leapfrog
# trajectory over the FULL unconstrained joint (models/logjoint.py),
# composed into the Gibbs sweep.
#
# NOT a reference kernel.  The round-5 attribution chain (BENCH_SUITE.md
# §3) ends at a COLLECTIVE soft mode of the co-adapted (Z, nu, Phi)
# configuration: within-block kernels — however collapsed or gradient-
# informed — move orthogonally to it, which is exactly the regime where a
# whole-model gradient trajectory (all blocks move together along the
# joint posterior's soft directions) is the right tool.  The target is
# the same posterior (make_log_joint carries the exact priors + transform
# Jacobians; parity covered by the HMC tests), so the composition is
# invariant; the production-sweep Geweke test proves it jointly when
# wired in via ``hmc_steps``.
#
# On REJECT the ORIGINAL state is returned (not the unconstrained
# round-trip, whose boundary clipping would otherwise nudge exact-zero Z
# entries — an invalid systematic drift).
# ---------------------------------------------------------------------------

def update_hmc_joint(key, state, data, hp, c, beta=1.0, *, eps=0.01,
                     n_leapfrog=8, inv_mass=None):
    """One jittered-length HMC trajectory on the whole unconstrained
    model.  ``inv_mass``: flat diagonal inverse mass (ravel_pytree order
    of models/logjoint.UncState) — pass warmup-frozen posterior variances
    for well-scaled trajectories; defaults to identity."""
    from jax.flatten_util import ravel_pytree

    from bayesfmmm_tpu.models import logjoint as lj_mod

    lj = lj_mod.make_log_joint(data, hp, c, temperature=beta)
    unc = lj_mod.from_state(state)
    flat, unravel = ravel_pytree(unc)
    if inv_mass is None:
        inv_mass = jnp.ones_like(flat)
    else:
        inv_mass = jnp.asarray(inv_mass, flat.dtype)

    vg = jax.value_and_grad(lambda q: lj(unravel(q)))
    logp0, grad0 = vg(flat)
    kp, ka, kj = jax.random.split(key, 3)
    p0 = jax.random.normal(kp, flat.shape, flat.dtype) / jnp.sqrt(inv_mass)
    n = jax.random.randint(kj, (), 1, n_leapfrog + 1)

    def body(_, carry):
        q, p, grad = carry
        p = p + 0.5 * eps * grad
        q = q + eps * inv_mass * p
        _, grad = vg(q)
        p = p + 0.5 * eps * grad
        return q, p, grad

    q, p, grad = jax.lax.fori_loop(0, n, body, (flat, p0, grad0))
    logp1, _ = vg(q)
    ke0 = 0.5 * jnp.sum(inv_mass * p0 * p0)
    ke1 = 0.5 * jnp.sum(inv_mass * p * p)
    log_acc = (logp1 - ke1) - (logp0 - ke0)
    ok = jnp.log(jax.random.uniform(ka)) < jnp.nan_to_num(
        log_acc, nan=-jnp.inf)
    new_state = lj_mod.to_state(unravel(q))
    return jax.tree.map(lambda a, b: jnp.where(ok, a, b), new_state, state)


# ---------------------------------------------------------------------------
# Sweep compositions — the three phase drivers' scan orders
# (BFMMM.h:1073-1100 phase 1; :1253-1298 phase 2; :1500-1554 phase 3;
# CovAdj orders from BFMMM.h:3742-3769, :3952-3999, :4810-4893).
# ---------------------------------------------------------------------------

def _keys(key, n):
    return list(jax.random.split(key, n))


def sweep_nu_z(key, state, data, hp, c, *, covariate_mean=False, beta=1.0):
    """Phase-1 sweep: Z, pi, alpha3, nu, tau, sigma [, eta, tau_eta].

    Phi is held at zero in this phase (BFMMM.h:1063), so the likelihood is
    chi-free by construction.
    """
    ks = _keys(key, 8)
    cache = build_cache(data, state)
    state, cache = update_z(ks[0], state, data, hp, cache, beta)
    state = update_pi(ks[1], state, hp, c)
    state = update_alpha3(ks[2], state, hp)
    state, cache = update_nu(ks[3], state, data, hp, cache, beta)
    state = update_tau(ks[4], state, data, hp)
    state = update_sigma(ks[5], state, data, hp, cache, beta)
    if covariate_mean:
        state, cache = update_eta(ks[6], state, data, hp, cache, beta)
        state = update_tau_eta(ks[7], state, data, hp)
    return state


def sweep_theta(key, state, data, hp, *, covariate_mean=False,
                covariate_cov=False, beta=1.0):
    """Phase-2 sweep: Phi tower + chi + sigma with (Z, nu[, eta]) pinned."""
    ks = _keys(key, 12)
    cache = build_cache(data, state)
    state, cache = update_phi(ks[0], state, data, hp, cache, beta)
    state = update_delta(ks[1], state, hp)
    state = update_a(ks[2], state, hp)
    state = update_gamma(ks[3], state, hp)
    state = update_tau(ks[4], state, data, hp)
    state = update_sigma(ks[5], state, data, hp, cache, beta)
    state, cache = update_chi(ks[6], state, data, hp, cache, beta)
    if covariate_mean:
        state = update_tau_eta(ks[7], state, data, hp)
    if covariate_cov:
        state, cache = update_xi(ks[8], state, data, hp, cache, beta)
        state = update_delta_xi(ks[9], state, hp)
        state = update_a_xi(ks[10], state, hp)
        state = update_gamma_xi(ks[11], state, hp)
    return state


def sweep_full(key, state, data, hp, c, *, covariate_mean=False,
               covariate_cov=False, beta=1.0, collapsed_z=False,
               gauge=False, p_indep=0.3, phi_chi_moves=0,
               phi_chi_sigma=0.1, phi_mala_steps=4, phi_mala_step=0.05,
               z_anchor=False, hmc_steps=0, hmc_eps=0.01,
               hmc_inv_mass=None):
    """Phase-3 (production) sweep.

    Plain order (BFMMM.h:1500-1554): Z, pi, alpha3, Phi, delta, A, gamma,
    nu, tau, sigma, chi.  Mean_CovAdj appends eta, tau_eta, xi, delta_xi,
    A_xi, gamma_xi (BFMMM.h:4810-4893).  ``beta`` < 1 gives the tempered
    sweep: only the data-likelihood-touching kernels consume it, matching
    the reference's choice of which updaters get Tempered variants.

    collapsed_z=True swaps the reference's chi-conditional Z kernel for the
    partially collapsed (Z, chi) block (update_z_chi) — same posterior,
    strictly better mixing across the Z/chi coupling; the production fit
    path and the benchmark use it (see update_z_chi block comment).
    """
    ks = _keys(key, 17)
    cache = build_cache(data, state)
    if collapsed_z:
        state, cache = update_z_chi(ks[0], state, data, hp, cache, beta,
                                    p_indep=p_indep, anchor_prop=z_anchor)
    else:
        state, cache = update_z(ks[0], state, data, hp, cache, beta)
    state = update_pi(ks[1], state, hp, c)
    state = update_alpha3(ks[2], state, hp)
    state, cache = update_phi(ks[3], state, data, hp, cache, beta)
    state = update_delta(ks[4], state, hp)
    state = update_a(ks[5], state, hp)
    state = update_gamma(ks[6], state, hp)
    state, cache = update_nu(ks[7], state, data, hp, cache, beta)
    state = update_tau(ks[8], state, data, hp)
    state = update_sigma(ks[9], state, data, hp, cache, beta)
    if collapsed_z:
        state, cache = update_chi_joint(ks[10], state, data, hp, cache, beta)
    else:
        state, cache = update_chi(ks[10], state, data, hp, cache, beta)
    if covariate_mean:
        state, cache = update_eta(ks[11], state, data, hp, cache, beta)
        state = update_tau_eta(ks[12], state, data, hp)
    if covariate_cov:
        state, cache = update_xi(ks[13], state, data, hp, cache, beta)
        state = update_delta_xi(ks[14], state, hp)
        state = update_a_xi(ks[15], state, hp)
        state = update_gamma_xi(ks[16], state, hp)
    if gauge:
        state = update_gauge(jax.random.fold_in(key, 1299709), state,
                             data, hp)
        # interweaved scale moves ride the same flag: all target the
        # measured slow directions beyond the reference's kernel census
        state, cache = update_mgp_scale(
            jax.random.fold_in(key, 2750159), state, data, hp,
            build_cache(data, state), beta)
        state, cache = update_noise_scale(
            jax.random.fold_in(key, 4256233), state, data, hp, cache, beta)
        if phi_chi_moves > 0:
            state, cache = update_phi_chi(
                jax.random.fold_in(key, 5800079), state, data, hp, cache,
                beta, sigma_rw=phi_chi_sigma, n_moves=phi_chi_moves)
        if phi_mala_steps > 0:
            state, cache = update_phi_mala(
                jax.random.fold_in(key, 7368787), state, data, hp, cache,
                beta, step=phi_mala_step, n_steps=phi_mala_steps)
        if hmc_steps > 0:
            state = update_hmc_joint(
                jax.random.fold_in(key, 9999991), state, data, hp, c,
                beta, eps=hmc_eps, n_leapfrog=hmc_steps,
                inv_mass=hmc_inv_mass)
    return state
