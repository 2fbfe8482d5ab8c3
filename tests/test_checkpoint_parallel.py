"""Checkpoint/resume determinism + mesh-sharded chain execution."""

import jax
import jax.numpy as jnp
import numpy as np

from bayesfmmm_tpu.config import ModelConfig, Priors
from bayesfmmm_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from bayesfmmm_tpu.models.state import init_state
from bayesfmmm_tpu.ops import gibbs
from bayesfmmm_tpu.parallel import mesh as pmesh
from bayesfmmm_tpu.utils.simulate import simulate_functional

HP = Priors()


def _small():
    data, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                  n_time=(10, 12))
    cfg = ModelConfig(K=2, P=5, M=2)
    return data, cfg


def test_checkpoint_exact_resume(tmp_path):
    """Resume must reproduce the exact trajectory (RNG key included) —
    capability absent from the reference (SURVEY.md §5)."""
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    key = jax.random.PRNGKey(3)
    state = init_state(key, cfg, data)

    # run 5 sweeps, checkpoint, run 5 more
    st = state
    k = key
    for i in range(5):
        k, ks = jax.random.split(k)
        st = gibbs.sweep_full(ks, st, data, HP, c)
    save_checkpoint(str(tmp_path / "ck"), st, k, iteration=5)

    cont = st
    kc = k
    for i in range(5):
        kc, ks = jax.random.split(kc)
        cont = gibbs.sweep_full(ks, cont, data, HP, c)

    st2, k2, it = load_checkpoint(str(tmp_path / "ck"))
    assert it == 5
    resumed = st2
    kr = k2
    for i in range(5):
        kr, ks = jax.random.split(kr)
        resumed = gibbs.sweep_full(ks, resumed, data, HP, c)

    for a, b in zip(jax.tree.leaves(cont), jax.tree.leaves(resumed)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_npz_checkpoint_round_trip_without_orbax(tmp_path, monkeypatch):
    """The checkpoint is plain npz: exact round trip with orbax absent,
    and a path without the suffix gets '.npz' appended."""
    import sys
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    data, cfg = _small()
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    states = jax.vmap(lambda k: init_state(k, cfg, data))(keys)
    save_checkpoint(str(tmp_path / "ens"), states, keys, iteration=12)
    assert (tmp_path / "ens.npz").is_file()
    back, kb, it = load_checkpoint(str(tmp_path / "ens"))
    assert it == 12
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(kb)),
                                  np.asarray(keys))
    for a, b in zip(jax.tree.leaves(states), jax.tree.leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_chains_match_unsharded():
    """The (chains, data) mesh execution computes the same draws as
    unsharded vmap — GSPMD must only change placement, not values."""
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    n_chains = 4
    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    states = jax.vmap(lambda k: init_state(k, cfg, data))(keys)

    step = jax.vmap(lambda k, s: gibbs.sweep_full(k, s, data, HP, c))
    ref = jax.jit(step)(keys, states)

    mesh = pmesh.make_mesh(n_chain_shards=4, n_data_shards=2)
    sdata = pmesh.shard_data(data, mesh)
    sstates = pmesh.shard_chain_states(states, mesh)
    skeys = jax.device_put(keys, pmesh.key_sharding(mesh))
    sharded = jax.jit(
        lambda k, s: jax.vmap(
            lambda kk, ss: gibbs.sweep_full(kk, ss, sdata, HP, c))(k, s)
    )(skeys, sstates)

    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(sharded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_mesh_shapes():
    m = pmesh.make_mesh()
    assert m.devices.size == len(jax.devices())
    m2 = pmesh.make_mesh(n_data_shards=2)
    assert m2.shape[pmesh.DATA_AXIS] == 2


def test_jit_determinism():
    """Same key + state -> identical draws across two jit executions
    (SURVEY.md §5 race-detection rebuild note)."""
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    key = jax.random.PRNGKey(7)
    state = init_state(key, cfg, data)
    f = jax.jit(lambda k, s: gibbs.sweep_full(k, s, data, HP, c))
    out1 = f(key, state)
    out2 = f(key, state)
    for a, b in zip(jax.tree.leaves(out1), jax.tree.leaves(out2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batched_run_with_async_persistence(tmp_path):
    """Reference ring-buffer semantics (BFMMM.h:205-271): batches of
    r_stored_iters, thinned, saved as Param{q}.txt, with mid-run
    checkpoints; multi-batch reload concatenates along iterations."""
    from bayesfmmm_tpu.samplers.batched import run_batched
    from bayesfmmm_tpu.io import armaio
    from bayesfmmm_tpu.io.checkpoint import load_checkpoint
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    state = init_state(jax.random.PRNGKey(5), cfg, data)
    final, ll, nb = run_batched(
        jax.random.PRNGKey(6), state, data, HP, c, directory=str(tmp_path),
        tot_mcmc_iters=200, r_stored_iters=100, thinning_num=2,
        checkpoint_every=1)
    assert nb == 2
    back = armaio.load_trace_dir(str(tmp_path))
    assert back["Nu"].shape[0] == 100      # 2 batches x 50 thinned draws
    assert np.isfinite(back["Sigma"]).all()
    st, k, it = load_checkpoint(str(tmp_path / "checkpoint"))
    assert it == 200


def test_parallel_tempering_sharded_replicas():
    """PT replicas sharded over the device mesh: the swap permutation
    lowers to collective-permute; results must match unsharded execution."""
    from bayesfmmm_tpu.parallel import tempering
    from jax.sharding import NamedSharding, PartitionSpec as P

    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    R = 8
    keys = jax.random.split(jax.random.PRNGKey(11), R)
    states = jax.vmap(lambda k: init_state(k, cfg, data))(keys)

    run = lambda k, s: tempering.run_parallel_tempering(
        k, s, data, HP, c, n_rounds=5, beta_min=0.4)
    cold_ref, _, rate_ref = jax.jit(run)(jax.random.PRNGKey(12), states)

    mesh = pmesh.make_mesh(n_chain_shards=8, n_data_shards=1)
    sharded_states = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P(*(("chains",) + (None,) * (x.ndim - 1))))), states)
    cold_sh, _, rate_sh = jax.jit(run)(jax.random.PRNGKey(12), sharded_states)

    np.testing.assert_allclose(np.asarray(rate_ref), np.asarray(rate_sh),
                               atol=1e-6)
    for a, b in zip(jax.tree.leaves(cold_ref), jax.tree.leaves(cold_sh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_resume_batched(tmp_path):
    """Resume continues file numbering and produces more batches."""
    from bayesfmmm_tpu.samplers.batched import run_batched, resume_batched
    from bayesfmmm_tpu.io import armaio
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    state = init_state(jax.random.PRNGKey(15), cfg, data)
    run_batched(jax.random.PRNGKey(16), state, data, HP, c,
                directory=str(tmp_path), tot_mcmc_iters=100,
                r_stored_iters=50, checkpoint_every=1)
    final, ll, nb = resume_batched(str(tmp_path), data, HP, c,
                                   additional_iters=100, r_stored_iters=50)
    assert nb == 2
    back = armaio.load_trace_dir(str(tmp_path))
    assert back["Nu"].shape[0] == 200    # 4 batches x 50


def test_fit_warm_start_ensemble_resume(tmp_path):
    """The warm-ensemble protocol through the PUBLIC API (round-4 VERDICT
    #7): checkpoint_to saves the full chain ensemble + per-chain keys;
    resume_from continues it deterministically (two resumes from the same
    checkpoint are bit-identical) with iteration bookkeeping chained."""
    from bayesfmmm_tpu import api
    data, cfg = _small()
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, seed=1)
    ck = str(tmp_path / "ens.npz")
    ra = api.fit_warm_start(r1, r2, tot_mcmc_iters=120, n_chains=3,
                            progress=False, checkpoint_to=ck)
    assert ra.ensemble_state.Z.shape[0] == 3

    rb = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                            progress=False)
    rc = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                            progress=False)
    assert rb.ensemble_state.Z.shape[0] == 3
    for k in rb.traces:
        np.testing.assert_array_equal(rb.traces[k], rc.traces[k])
    # the resumed ensemble actually moved from the checkpointed state
    assert float(jnp.max(jnp.abs(
        rb.ensemble_state.nu - ra.ensemble_state.nu))) > 1e-6

    # chained resume: iteration bookkeeping accumulates, randomness fresh
    ck2 = str(tmp_path / "ens2.npz")
    api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                       progress=False, checkpoint_to=ck2)
    _, _, it = load_checkpoint(ck2)
    assert it == 220
    rd = api.fit_warm_start(resume_from=ck2, data=data, tot_mcmc_iters=100,
                            progress=False)
    assert not np.array_equal(rd.traces["nu"][:100],
                              rb.traces["nu"][:100])


def test_resume_batched_refuses_stale_directory(tmp_path):
    """A directory whose batch count disagrees with the checkpoint's stored
    iteration must be refused, not silently spliced (round-1 VERDICT)."""
    import pytest

    from bayesfmmm_tpu.samplers.batched import resume_batched, run_batched
    data, cfg = _small()
    c = jnp.full((2,), 10.0)
    state = init_state(jax.random.PRNGKey(25), cfg, data)
    run_batched(jax.random.PRNGKey(26), state, data, HP, c,
                directory=str(tmp_path), tot_mcmc_iters=100,
                r_stored_iters=50, checkpoint_every=1)
    # simulate a stale directory: an extra foreign batch appears
    import shutil
    shutil.copy(tmp_path / "Nu0.txt", tmp_path / "Nu2.txt")
    with pytest.raises(ValueError, match="refusing to mix trajectories"):
        resume_batched(str(tmp_path), data, HP, c,
                       additional_iters=50, r_stored_iters=50)
