"""benchmarks/utilization.py peak table."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))

from utilization import device_peaks  # noqa: E402


def test_device_peaks_resolve_h100():
    kind, peaks = device_peaks(
        types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3"))
    assert kind == "NVIDIA H100 80GB HBM3"
    assert peaks == dict(bf16_flops=989e12, f32_flops=67e12,
                         hbm_bytes_per_s=3.35e12)


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", "NVIDIA H100"])
def test_device_peaks_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(types.SimpleNamespace(device_kind=kind))
