"""benchmarks/sweep_profile.py's trace reduction helpers (CPU)."""

import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))

import sweep_profile as sp  # noqa: E402


def test_union_of_intervals():
    assert sp._union_ns([(0, 5), (3, 8), (10, 12), (11, 11)]) == 10
    assert sp._union_ns([]) == 0


def test_hlo_ops_map_to_named_scope_and_emitting_function():
    def draw(a):
        with jax.named_scope(sp.SCOPE):
            return jnp.linalg.cholesky(a @ a.T + 4.0 * jnp.eye(4))

    text = jax.jit(draw).lower(jnp.ones((4, 4))).compile().as_text()
    meta = sp.hlo_metadata(text)
    frames = sp.frame_functions(text)
    scoped = [m for m in meta.values() if sp.SCOPE in m.get("op_name", "")]
    assert scoped
    fns = {frames.get(m.get("stack_frame_id")) for m in scoped}
    assert any(f and f.startswith("test_sweep_profile.py:")
               and f.endswith("<locals>.draw") for f in fns), fns
