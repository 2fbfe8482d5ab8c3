"""Decompose the cross-chain loglik spread (the residual R-hat direction).

Round-5 question: after the scale interweaves, WHAT still differs between
chains?  loglik = -n/2 log(2 pi sigma2) - RSS/(2 sigma2) — decompose the
ensemble spread into
  * profile fit quality: -n/2 (1 + log(RSS/n))  (sigma2 profiled out),
  * the sigma2 wiggle around its conditional optimum,
and characterize the eigen-subspace alignment across chains: per-column
data-explained energy and principal angles of span(B-projected columns)
between chains.

Usage: python benchmarks/fit_spread_diag.py
"""

from __future__ import annotations

import json
import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from bayesfmmm_tpu.io.checkpoint import load_checkpoint
    from bayesfmmm_tpu.ops.mean import (effective_coeffs, eigen_directions,
                                        rss_from_coeffs)
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    K, P, M, N = 3, 8, 4, 100
    data, _ = simulate_functional(seed=7, N=N, K=K, P=P, M=M,
                                  n_time=(100, 100))
    ckpt = os.path.expanduser(
        "~/.cache/bfmmm_bench/ens_c256_w150000_g1_z1_p0.3_seed7.npz")
    states, _, _ = load_checkpoint(ckpt, dtype=data.y.dtype)
    C = int(states.Z.shape[0])
    n_tot = float(jnp.sum(data.mask))

    @jax.jit
    @jax.vmap
    def stats(st):
        w = effective_coeffs(st, data.X)
        rss = rss_from_coeffs(data, w)
        prof = -0.5 * n_tot * (1.0 + jnp.log(rss / n_tot))
        ll = -0.5 * n_tot * jnp.log(st.sigma2) - rss / (2.0 * st.sigma2)
        # per-column explained energy: ||sum_n B_n U_nm chi_nm||^2 per m
        U = eigen_directions(st, data.X)                    # (N, P, M)
        contrib = U * st.chi[:, None, :]                    # (N, P, M)
        en = jnp.einsum("npm,npq,nqm->m", contrib, data.G, contrib)
        return prof, ll, rss, en

    prof, ll, rss, en = stats(states)
    prof, ll, rss, en = map(np.asarray, (prof, ll, rss, en))

    # principal angles between chains' B-projected eigen subspaces
    # (population average direction space): project each chain's K*M
    # feature-columns through the mean basis Gram
    import numpy.linalg as la
    G_mean = np.asarray(jnp.mean(data.G, axis=0))
    L = la.cholesky(G_mean + 1e-9 * np.eye(G_mean.shape[0]))
    Phi = np.asarray(states.Phi)                            # (C, K, P, M)
    subs = []
    for ci in range(C):
        A = (L.T @ Phi[ci].transpose(1, 0, 2).reshape(
            Phi.shape[2], -1))                              # (P, K*M)
        q, _ = la.qr(A)
        subs.append(q[:, :min(A.shape[1], A.shape[0])])
    ref = subs[int(np.argmax(prof))]
    angs = []
    for ci in range(C):
        s = la.svd(ref.T @ subs[ci], compute_uv=False)
        s = np.clip(s, -1, 1)
        angs.append(np.degrees(np.arccos(s)))
    angs = np.array(angs)          # (C, dims) principal angles vs best chain

    out = {
        "chains": C,
        "loglik_sd": float(ll.std()),
        "profile_loglik_sd": float(prof.std()),
        "sigma2_wiggle_sd": float((ll - prof).std()),
        "corr_ll_prof": float(np.corrcoef(ll, prof)[0, 1]),
        "rss_mean": float(rss.mean()), "rss_sd": float(rss.std()),
        "col_energy_mean": [round(float(x), 2)
                            for x in en.mean(axis=0)],
        "col_energy_sd": [round(float(x), 2) for x in en.std(axis=0)],
        "principal_angle_deg_mean": [round(float(x), 1)
                                     for x in angs.mean(axis=0)],
        "principal_angle_deg_max": [round(float(x), 1)
                                    for x in angs.max(axis=0)],
        "worst_minus_best_profile_ll": float(prof.max() - prof.min()),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
