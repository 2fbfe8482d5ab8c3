"""B-spline basis construction and smoothness penalties (host-side, NumPy f64).

Rebuild of the reference basis layer:
  * 1-D B-spline design matrices  — reference builds these per function with
    ``splines2::BSpline(...).basis(true)`` (BFMMM.h:1388-1400).
  * Tensor-product B-spline bases for multi-dimensional domains — reference
    ``TensorBSpline`` (BSplines.h:18-62).
  * RW(1) tridiagonal penalty for 1-D domains (BFMMM.h:1402-1412).
  * Graph-difference penalty for tensor domains — reference ``GetP``
    (BSplines.h:70-120), golden-tested against inst/test-data/P_mat.txt.

Basis construction is data preparation: it runs once on the host in float64
NumPy and its outputs are shipped to the device as constants.  The MCMC hot
path never re-evaluates splines (unlike the reference, which rebuilds bases
inside every driver).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bspline_basis",
    "tensor_bspline_basis",
    "rw1_penalty",
    "tensor_penalty",
    "mixed_radix_indices",
]


def _knot_vector(internal_knots: np.ndarray, degree: int,
                 boundary_knots: np.ndarray) -> np.ndarray:
    """Clamped knot vector: boundary knots repeated ``degree + 1`` times."""
    lo, hi = float(boundary_knots[0]), float(boundary_knots[1])
    internal_knots = np.asarray(internal_knots, dtype=np.float64).ravel()
    return np.concatenate([
        np.full(degree + 1, lo),
        internal_knots,
        np.full(degree + 1, hi),
    ])


def bspline_basis(t: np.ndarray, degree: int, internal_knots: np.ndarray,
                  boundary_knots: np.ndarray) -> np.ndarray:
    """Complete (intercept-including) B-spline basis evaluated at ``t``.

    Matches ``splines2::BSpline(t, internal_knots, degree, boundary).basis(true)``
    as used at BFMMM.h:1392-1399: the full basis of
    ``P = len(internal_knots) + degree + 1`` columns, with the conventional
    right-closure (the basis at the right boundary point evaluates to the
    last unit vector).

    Args:
      t: (n,) evaluation points inside ``[boundary_knots[0], boundary_knots[1]]``.
      degree: spline degree (3 = cubic).
      internal_knots: (n_knots,) strictly interior knots.
      boundary_knots: (2,) domain endpoints.

    Returns:
      (n, P) float64 design matrix.
    """
    t = np.asarray(t, dtype=np.float64).ravel()
    knots = _knot_vector(internal_knots, degree, boundary_knots)
    n_basis = len(knots) - degree - 1

    hi = float(boundary_knots[1])

    # Cox–de Boor recursion, vectorized over evaluation points.
    # Degree-0: indicator of [knots[j], knots[j+1]), right-closed at the
    # domain end so the final basis function is 1 at t == hi.
    n_seg = len(knots) - 1
    B = np.zeros((t.shape[0], n_seg), dtype=np.float64)
    for j in range(n_seg):
        left, right = knots[j], knots[j + 1]
        if right > left:
            sel = (t >= left) & ((t < right) | ((t == hi) & (right == hi)))
            B[sel, j] = 1.0

    for d in range(1, degree + 1):
        B_next = np.zeros((t.shape[0], n_seg - d), dtype=np.float64)
        for j in range(n_seg - d):
            denom1 = knots[j + d] - knots[j]
            denom2 = knots[j + d + 1] - knots[j + 1]
            term = np.zeros_like(t)
            if denom1 > 0:
                term = term + (t - knots[j]) / denom1 * B[:, j]
            if denom2 > 0:
                term = term + (knots[j + d + 1] - t) / denom2 * B[:, j + 1]
            B_next[:, j] = term
        B = B_next

    assert B.shape[1] == n_basis
    return B


def mixed_radix_indices(sizes: list[int]) -> np.ndarray:
    """Multi-indices of the tensor-basis columns, last dimension fastest.

    Reproduces the mixed-radix counter walk of the reference
    (BSplines.h:38-59 / :87-97): column ``i`` of the tensor basis is the
    product of per-dimension basis functions with indices
    ``(i // stride_l) % sizes[l]`` where ``stride_l = prod(sizes[l+1:])``.

    Returns:
      (P, dim) int array of per-dimension basis indices.
    """
    sizes = list(sizes)
    P = int(np.prod(sizes))
    strides = np.ones(len(sizes), dtype=np.int64)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    cols = np.arange(P, dtype=np.int64)
    return np.stack([(cols // strides[l]) % sizes[l]
                     for l in range(len(sizes))], axis=1)


def tensor_bspline_basis(t: np.ndarray, degrees, internal_knots_list,
                         boundary_knots: np.ndarray) -> np.ndarray:
    """Tensor-product B-spline basis for multi-dimensional domains.

    Reference: ``TensorBSpline`` (BSplines.h:18-62).  Each column of the
    result is a product over dimensions of 1-D basis functions, ordered by
    the mixed-radix walk (last dimension fastest).

    Args:
      t: (n, dim) evaluation points (each column a domain dimension).
      degrees: per-dimension spline degrees, length dim.
      internal_knots_list: per-dimension interior knot arrays.
      boundary_knots: (dim, 2) per-dimension domain endpoints.

    Returns:
      (n, prod(P_l)) float64 design matrix.
    """
    t = np.asarray(t, dtype=np.float64)
    if t.ndim == 1:
        t = t[:, None]
    dim = t.shape[1]
    bases = [
        bspline_basis(t[:, l], int(degrees[l]), internal_knots_list[l],
                      np.asarray(boundary_knots)[l])
        for l in range(dim)
    ]
    sizes = [b.shape[1] for b in bases]
    idx = mixed_radix_indices(sizes)
    B = np.ones((t.shape[0], idx.shape[0]), dtype=np.float64)
    for l in range(dim):
        B *= bases[l][:, idx[:, l]]
    return B


def rw1_penalty(P: int) -> np.ndarray:
    """First-order random-walk (tridiagonal) penalty matrix.

    Reference: the P_mat built inline in every functional driver
    (BFMMM.h:1402-1412): diag = [1, 2, ..., 2, 1], off-diag = -1.
    Singular (rank P-1); only ever used added to a positive-definite data
    term or pseudo-inverted.
    """
    M = np.zeros((P, P), dtype=np.float64)
    for j in range(P):
        M[0, 0] = 1.0
        if j > 0:
            M[j, j] = 2.0
            M[j - 1, j] = -1.0
            M[j, j - 1] = -1.0
        M[P - 1, P - 1] = 1.0
    return M


def tensor_penalty(degrees, internal_knots_list) -> np.ndarray:
    """Graph-difference penalty for tensor-product bases.

    Reference: ``GetP`` (BSplines.h:70-120), golden fixture
    inst/test-data/P_mat.txt.  Builds a difference matrix with one row per
    pair of tensor-basis columns whose multi-indices differ by +1 in exactly
    one dimension, then returns ``C' C``.
    """
    sizes = [len(np.asarray(internal_knots_list[l]).ravel()) + int(degrees[l]) + 1
             for l in range(len(degrees))]
    idx = mixed_radix_indices(sizes)
    P = idx.shape[0]
    rows = []
    for i in range(P):
        for j in range(i, P):
            diff = idx[j] - idx[i]
            if diff.sum() == 1 and np.abs(diff).sum() == 1:
                row = np.zeros(P, dtype=np.float64)
                row[i] = 1.0
                row[j] = -1.0
                rows.append(row)
    C = np.stack(rows) if rows else np.zeros((0, P), dtype=np.float64)
    return C.T @ C
