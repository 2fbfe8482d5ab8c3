"""Immutable dataclasses registered as JAX pytrees.

``pytree_dataclass`` makes a frozen dataclass whose fields are pytree
leaves, except those declared with ``static_field``: those are pytree
metadata (hashed into ``jit`` cache keys, never traced or batched).
Instances get ``replace(**changes)``, which returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


def static_field(default):
    """A field kept out of the pytree's leaves (hashable metadata)."""
    return dataclasses.field(default=default, metadata=dict(static=True))
