"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

import os

import jax
import pytest

from bayesfmmm_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")


def test_default_is_fixed_gitignored_dir_in_checkout(monkeypatch,
                                                     restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR == os.path.join(REPO,
                                                             ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
