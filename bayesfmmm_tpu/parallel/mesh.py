"""Device mesh + sharding layer: chain- and data-parallel MCMC.

The reference is strictly single-threaded (SURVEY.md §2.2: OpenMP flags
declared in src/Makevars:2-4 but zero pragma sites; restarts are serial,
UserFunctions.cpp:311-325).  The replacements:

  * **Chain parallelism**: restarts/chains are a vmapped batch whose leading
    axis shards over the ``chains`` mesh axis.
  * **Data parallelism**: the N observations shard over the ``data`` axis.
    Every likelihood/Gibbs reduction over observations (the einsum
    contractions over `n` in ops/gibbs.py) lowers to a partial sum + psum
    inserted automatically by GSPMD — the idiomatic XLA collective design:
    annotate shardings, let the compiler place `psum`/`all-gather`.
  * **Multi-host**: `jax.distributed.initialize()` + the same mesh spanning
    all hosts; nothing else changes (see initialize_distributed).

Per-observation state (Z rows, chi rows) shards with the data; global
parameters (nu, Phi, ...) replicate — they are tiny.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def initialize_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host bring-up; no-op on a single process."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_chain_shards=None, n_data_shards=None, devices=None) -> Mesh:
    """Build a (chains, data) mesh over the available devices.

    Defaults put all devices on the chains axis — the dominant parallelism
    for MCMC (independent chains need zero communication).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_chain_shards is None and n_data_shards is None:
        n_chain_shards, n_data_shards = n, 1
    elif n_chain_shards is None:
        n_chain_shards = n // n_data_shards
    elif n_data_shards is None:
        n_data_shards = n // n_chain_shards
    assert n_chain_shards * n_data_shards == n, (
        f"mesh {n_chain_shards}x{n_data_shards} != {n} devices")
    return Mesh(devices.reshape(n_chain_shards, n_data_shards),
                (CHAIN_AXIS, DATA_AXIS))


def data_sharding(mesh: Mesh):
    """Shardings for ModelData: N-leading arrays split over the data axis."""
    def spec(arr_name):
        if arr_name == "pen":
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(DATA_AXIS))
    return spec


def shard_data(data, mesh: Mesh):
    """Place a ModelData onto the mesh (N rows over the data axis)."""
    spec = data_sharding(mesh)
    return type(data)(
        y=jax.device_put(data.y, spec("y")),
        mask=jax.device_put(data.mask, spec("mask")),
        B=jax.device_put(data.B, spec("B")),
        X=jax.device_put(data.X, spec("X")),
        G=jax.device_put(data.G, spec("G")),
        pen=jax.device_put(data.pen, spec("pen")),
        u=jax.device_put(data.u, spec("u")),
        yy=jax.device_put(data.yy, spec("yy")),
        identity_basis=data.identity_basis,
        family=data.family,
    )


def chain_state_sharding(mesh: Mesh, state_batch):
    """Shardings for a chains-leading batched GibbsState.

    Chain axis shards over CHAIN_AXIS; the per-observation parameters
    (Z, chi) additionally shard their N axis over DATA_AXIS.
    """
    def spec_for(path, leaf):
        name = path[-1].name if hasattr(path[-1], "name") else str(path[-1])
        if name in ("Z", "chi"):
            return NamedSharding(mesh, P(CHAIN_AXIS, DATA_AXIS))
        return NamedSharding(
            mesh, P(*( (CHAIN_AXIS,) + (None,) * (leaf.ndim - 1) )))

    return jax.tree_util.tree_map_with_path(spec_for, state_batch)


def shard_chain_states(state_batch, mesh: Mesh):
    shardings = chain_state_sharding(mesh, state_batch)
    return jax.tree.map(jax.device_put, state_batch, shardings)


def key_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(CHAIN_AXIS))
