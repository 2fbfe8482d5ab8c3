"""Linear algebra for the Gibbs sweep's hot path.

Inside a `lax.scan` sweep the op graph is latency-serialized (iteration
i+1 depends on i), so the number of sequential steps in a factorization or
substitution, not its FLOPs, sets its cost.  Two reformulations, both exact
(same arithmetic, reordered):

  * `blocked_tri_solves(L, b, z)` — block forward/backward substitution
    with the diagonal blocks inverted upfront by ONE batched
    triangular-solve call, then ~2*NB sequential steps of batched matmuls
    instead of ~D row steps.
  * `small_chol` / `small_solve_lower` / `small_solve_upper_t` and the
    `*_entries` forms — entrywise UNROLLED Cholesky/substitution for static
    M <= 8, holding each matrix entry as its own (batch...)-shaped array so
    every op runs over the large batch dims.

The joint blocked draws (update_phi/update_xi) route through
`mvn_from_precision_fused` -> `precision_draw_pair`: XLA's batched
Cholesky followed by `blocked_tri_solves`.  The M-space kernels
(update_chi_joint, update_z_chi) use the small_* unrolled forms.
`blocked_cholesky` / `mvn_from_chol_blocked` / `BLOCKED_MIN_DIM` are kept
as benchmark/test references for the blocked path (benchmarks/
kernel_breakdown.py, tests/test_linalg.py) — no production kernel calls
them directly.  Exactness is covered by tests/test_linalg.py, the kernel
recovery tests and the Geweke joint-invariance suites.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = dict(precision="highest")

# Above this dimension the stock lowering's per-row latency dominates and
# the blocked substitution wins; below it the plain solve is already cheap.
BLOCKED_MIN_DIM = 32


def _stock():
    """BFMMM_STOCK_LINALG=1 routes every latency-tuned path back to the
    stock XLA lowerings (value-equivalent; see tests/test_linalg.py).  Used
    by the FLOPs cross-check: XLA's cost_analysis mis-counts the blocked
    substitution network ~8x (slicing a cholesky result inflates the
    counted while-loop flops), so the analytic-vs-XLA pin runs against the
    canonical schedule that computes the same math."""
    import os
    return os.environ.get("BFMMM_STOCK_LINALG", "0") == "1"


def _pick_block(D):
    for bs in (16, 12, 8):
        if D % bs == 0:
            return bs
    return None


def blocked_tri_solves(L, b, z, *, block=None):
    """(mean, noise) of a precision-Cholesky draw via blocked substitution.

    mean = L^{-T} L^{-1} b,  noise = L^{-T} z,  for lower-triangular L of
    static dimension D = NB*BS.  The NB diagonal blocks are inverted with
    one batched triangular_solve (latency ~BS steps, amortized), then
    forward/backward substitution runs in NB sequential steps of batched
    (..., BS, BS) matmuls — ~D/NB times fewer serial ops
    than the stock row-by-row lowering.
    """
    D = L.shape[-1]
    BS = block or _pick_block(D)
    if BS is None or _stock():
        w = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
        rhs = jnp.concatenate([w, z[..., None]], axis=-1)
        out = jax.scipy.linalg.solve_triangular(L.mT, rhs, lower=False)
        return out[..., 0], out[..., 1]
    NB = D // BS
    batch = L.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(BS, dtype=L.dtype),
                           batch + (NB, BS, BS))
    dblocks = jnp.stack(
        [L[..., i * BS:(i + 1) * BS, i * BS:(i + 1) * BS]
         for i in range(NB)], axis=-3)
    Dinv = jax.scipy.linalg.solve_triangular(dblocks, eye, lower=True)

    def blk(i, j):
        return L[..., i * BS:(i + 1) * BS, j * BS:(j + 1) * BS]

    # forward: w_i = Dinv_i (b_i - sum_{j<i} L_ij w_j)
    ws = []
    for i in range(NB):
        acc = b[..., i * BS:(i + 1) * BS]
        for j in range(i):
            acc = acc - jnp.einsum("...pq,...q->...p", blk(i, j), ws[j],
                                   **_HI)
        ws.append(jnp.einsum("...pq,...q->...p", Dinv[..., i, :, :], acc,
                             **_HI))
    # backward with U = L^T, two stacked rhs (w, z):
    #   y_i = Dinv_i^T (rhs_i - sum_{j>i} L_ji^T y_j)
    rhs = jnp.stack([jnp.concatenate(ws, -1), z], axis=-2)  # (..., 2, D)
    ys = [None] * NB
    for i in reversed(range(NB)):
        acc = rhs[..., :, i * BS:(i + 1) * BS]
        for j in range(i + 1, NB):
            acc = acc - jnp.einsum("...qp,...rq->...rp", blk(j, i), ys[j],
                                   **_HI)
        ys[i] = jnp.einsum("...qp,...rq->...rp", Dinv[..., i, :, :], acc,
                           **_HI)
    y = jnp.concatenate(ys, -1)                             # (..., 2, D)
    return y[..., 0, :], y[..., 1, :]


def blocked_cholesky(A, *, block=None):
    """Left-looking blocked Cholesky of SPD (..., D, D) for static D.

    ~4 ops per block row (two einsum accumulations, one BS-dim stock
    Cholesky, one batched BS-dim triangular panel solve), touching O(D*BS)
    entries per step instead of rewriting the full (batch, D, D) tensor
    each of D steps.
    """
    D = A.shape[-1]
    BS = block or _pick_block(D)
    if BS is None or D <= 2 * BS:
        return jnp.linalg.cholesky(A)
    NB = D // BS
    batch = A.shape[:-2]
    # block grid view: Ab[..., i, j, :, :] = A[i*BS:(i+1)*BS, j*BS:(j+1)*BS]
    Ab = A.reshape(batch + (NB, BS, NB, BS)).swapaxes(-3, -2)
    L = [[None] * NB for _ in range(NB)]
    for j in range(NB):
        S = Ab[..., j, j, :, :]
        if j > 0:
            Lrow = jnp.stack([L[j][k] for k in range(j)], axis=-3)
            S = S - jnp.einsum("...kab,...kcb->...ac", Lrow, Lrow, **_HI)
        Ljj = jnp.linalg.cholesky(S)
        L[j][j] = Ljj
        if j + 1 < NB:
            Pnl = Ab[..., j + 1:, j, :, :]               # (..., NB-j-1, BS, BS)
            if j > 0:
                Lbelow = jnp.stack(
                    [jnp.stack([L[i][k] for k in range(j)], axis=-3)
                     for i in range(j + 1, NB)], axis=-4)
                Pnl = Pnl - jnp.einsum("...ikab,...kcb->...iac",
                                       Lbelow, Lrow, **_HI)
            # panel: L[i][j] = Pnl_i @ Ljj^{-T}  (solve on the right)
            X = jax.scipy.linalg.solve_triangular(
                jnp.broadcast_to(Ljj[..., None, :, :],
                                 Pnl.shape[:-2] + (BS, BS)),
                jnp.swapaxes(Pnl, -1, -2), lower=True)
            X = jnp.swapaxes(X, -1, -2)
            for idx, i in enumerate(range(j + 1, NB)):
                L[i][j] = X[..., idx, :, :]
    zeros = jnp.zeros(batch + (BS, BS), dtype=A.dtype)
    rows = [jnp.concatenate([L[i][j] if j <= i else zeros
                             for j in range(NB)], axis=-1)
            for i in range(NB)]
    return jnp.concatenate(rows, axis=-2)


def mvn_from_chol_blocked(key, L, b):
    """Sample N(prec^{-1} b, prec^{-1}) given L = chol(prec), using the
    blocked substitution path for large static D.  Same contract as
    distributions.mvn_from_chol; returns (sample, mean)."""
    z = jax.random.normal(key, b.shape, dtype=b.dtype)
    mean, noise = blocked_tri_solves(L, b, z)
    return mean + noise, mean


# ---------------------------------------------------------------------------
# Entrywise-unrolled small-matrix Cholesky / substitution (static M <= 8).
# Matrices are (..., M, M); internally each entry lives as its own
# (...)-shaped array so no (.., M, M) tile-padded intermediate is touched
# per step.
# ---------------------------------------------------------------------------

SMALL_MAX_DIM = 8


def small_chol(A):
    """Cholesky of SPD (..., M, M), unrolled over entries for static M."""
    M = A.shape[-1]
    if M > SMALL_MAX_DIM or _stock():
        return jnp.linalg.cholesky(A)
    a = [[A[..., i, j] for j in range(M)] for i in range(M)]
    L = [[None] * M for _ in range(M)]
    for j in range(M):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, M):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = jnp.zeros_like(a[0][0])
    rows = [jnp.stack([L[i][j] if j <= i else zero for j in range(M)],
                      axis=-1) for i in range(M)]
    return jnp.stack(rows, axis=-2)


def small_solve_lower(L, b):
    """x with L x = b; L (..., M, M) lower-triangular, b (..., M)."""
    M = L.shape[-1]
    if M > SMALL_MAX_DIM or _stock():
        return jax.scipy.linalg.solve_triangular(
            L, b[..., None], lower=True)[..., 0]
    x = []
    for i in range(M):
        s = b[..., i]
        for j in range(i):
            s = s - L[..., i, j] * x[j]
        x.append(s / L[..., i, i])
    return jnp.stack(x, axis=-1)


def small_solve_upper_t(L, b):
    """x with L^T x = b (upper substitution on the transpose of lower L)."""
    M = L.shape[-1]
    if M > SMALL_MAX_DIM or _stock():
        return jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), b[..., None], lower=False)[..., 0]
    x = [None] * M
    for i in reversed(range(M)):
        s = b[..., i]
        for j in range(i + 1, M):
            s = s - L[..., j, i] * x[j]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def precision_draw_pair(A, b, z):
    """(mean, noise) with mean = A^{-1} b, noise = chol(A)^{-T} z: XLA's
    (batched) Cholesky followed by the blocked substitution."""
    L = jnp.linalg.cholesky(A)
    return blocked_tri_solves(L, b, z)


def mvn_from_precision_fused(key, A, b, *, jitter=1e-6):
    """Sample N(A^{-1} b, A^{-1}) with the same diagonal-jitter contract as
    distributions.chol_precision; (sample, mean)."""
    D = A.shape[-1]
    scale = jnp.trace(A, axis1=-2, axis2=-1) / D + 1.0
    Aj = A + (jitter * scale)[..., None, None] * jnp.eye(D, dtype=A.dtype)
    z = jax.random.normal(key, b.shape, dtype=b.dtype)
    mean, noise = precision_draw_pair(Aj, b, z)
    return mean + noise, mean


def small_chol_logdet(L):
    """log det of the SPD matrix whose Cholesky factor is L: 2*sum log diag."""
    return 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


# ---------------------------------------------------------------------------
# Entries interface — small-matrix linalg WITHOUT the (.., M, M) tensor.
#
# These helpers take and return the M(M+1)/2 entries as SEPARATE
# (batch...)-shaped arrays, so no packed trailing-(M, M) tensor is ever
# materialized; callers build each entry with one tiny contraction.
# Arithmetic is identical to small_chol/small_solve_*.
# ---------------------------------------------------------------------------


def small_chol_entries(a):
    """Cholesky of the SPD matrix whose lower-tri entries are a[i][j]
    ((batch...)-shaped arrays, j <= i); returns L in the same ragged
    lower-triangular format (row i has i + 1 entries)."""
    M = len(a)
    L = [[None] * (i + 1) for i in range(M)]
    for j in range(M):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, M):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L


def small_solve_lower_entries(L, b):
    """x with L x = b; b and x are length-M lists of (batch...) arrays."""
    M = len(b)
    x = []
    for i in range(M):
        s = b[i]
        for j in range(i):
            s = s - L[i][j] * x[j]
        x.append(s / L[i][i])
    return x


def small_solve_upper_t_entries(L, b):
    """x with L^T x = b for lower-triangular entries L."""
    M = len(b)
    x = [None] * M
    for i in reversed(range(M)):
        s = b[i]
        for j in range(i + 1, M):
            s = s - L[j][i] * x[j]
        x[i] = s / L[i][i]
    return x


def small_logdet_entries(L):
    """log det of the SPD matrix with Cholesky entries L."""
    out = 2.0 * jnp.log(L[0][0])
    for i in range(1, len(L)):
        out = out + 2.0 * jnp.log(L[i][i])
    return out
