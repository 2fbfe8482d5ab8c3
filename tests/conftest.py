"""Test harness: CPU backend with an 8-device virtual mesh.

Multi-device sharding is validated on a forced-host-platform device mesh
(SURVEY.md §4: the reference has no multi-node tests; we add mesh emulation
as the rebuild's equivalent).  Tests marked ``gpu`` need a card; they skip
here and run on the GPU through ``python chip_smoke.py``, which loads them
without this file.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite compiles ~60 XLA programs; cached
# reruns skip nearly all of that.
from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1)
