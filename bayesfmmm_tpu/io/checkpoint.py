"""Exact-state checkpoint / resume for the sampler.

The reference has NO exact-state resume: its two mechanisms are batch trace
persistence (BFMMM.h:205-271) and warm-starting from point estimates
(UserFunctions.cpp:1557-1650) — RNG state is lost (SURVEY.md §5).  Here a
checkpoint captures the full sampler state pytree *and* the PRNG key, so a
resumed chain continues the exact same trajectory.

The format is one NumPy ``.npz`` archive: one array per GibbsState field
(``state__<field>``), the raw key data and the iteration count.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from bayesfmmm_tpu.models.state import GibbsState

_FIELDS = [f.name for f in dataclasses.fields(GibbsState)]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state, key, iteration: int = 0) -> None:
    """Save (state, key, iteration) — exact-resume contract.

    Writes ``path`` if it ends in ``.npz`` and ``path + '.npz'`` otherwise.
    ``key`` may be a typed PRNG key array or raw uint32 key data."""
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    arrs = {f"state__{f}": np.asarray(getattr(state, f)) for f in _FIELDS}
    arrs["key"] = np.asarray(key)
    arrs["iteration"] = np.asarray(iteration)
    np.savez(_npz_path(path), **arrs)


def load_checkpoint(path: str, dtype=None):
    """Returns (state, key, iteration); ``key`` is a typed PRNG key array."""
    dtype = dtype or jnp.float32
    with np.load(_npz_path(path)) as z:
        state = GibbsState(**{f: jnp.asarray(z[f"state__{f}"], dtype)
                              for f in _FIELDS})
        key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
        return state, key, int(z["iteration"])
