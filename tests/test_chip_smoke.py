"""chip_smoke.py's device gate and phase functions, at toy sizes on the CPU
(the script itself refuses to run without a GPU)."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

def test_check_device_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_device()
    assert e.value.code == 2


def test_main_exits_nonzero_without_printing_a_result(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("phase", ["draw", "small_entries", "mean_lik"])
def test_parity_phases_pass_at_toy_sizes(phase):
    if phase == "draw":
        res = chip_smoke.parity_precision_draw(4, 48)
    elif phase == "small_entries":
        res = chip_smoke.parity_small_entries(64, 4)
    else:
        from bayesfmmm_tpu.utils.simulate import simulate_functional
        data, truth = simulate_functional(seed=1, N=10, K=2, P=6, M=2,
                                          n_time=(12, 12))
        res = chip_smoke.parity_mean_likelihood(data, truth)
    assert 0.0 <= res["max_rel_err"] <= res["bound"]


def test_tolerance_rejects_tf32_rounding():
    """Inputs rounded to TF32's 10-bit mantissa miss the effective_coeffs
    bound: the parity phase can tell TF32 from float32."""
    rng = np.random.default_rng(0)
    Z, nu = rng.dirichlet(np.ones(3), size=100), 3 * rng.normal(size=(3, 8))

    def tf32(x):
        m, e = np.frexp(x)
        return np.ldexp(np.round(m * 2 ** 11) / 2 ** 11, e)

    err = chip_smoke._rel_err(tf32(Z) @ tf32(nu), Z @ nu)
    assert err > chip_smoke.TOLERANCES["effective_coeffs"]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._within("effective_coeffs", {"w": err})


def test_sweep_phase_few_chains():
    """The headline data (the loglik bound assumes the data dominate the
    prior, which toy sizes do not), 2 chains, 2 x 10 sweeps."""
    res = chip_smoke.run_headline_sweep(n_chains=2, n_sweeps=10)
    assert res["chain_sweeps_per_s"] > 0
    assert abs(res["loglik_gap"]) <= res["loglik_bound"]


def test_four_card_path_on_virtual_devices():
    """--four-cards at 16 chains on four of the suite's virtual CPU
    devices: sharded outputs span the mesh and match the one-device run."""
    assert len(jax.devices()) >= 4
    res = chip_smoke.run_four_cards(n_chains=16)
    assert set(res["meshes"]) == {"4x1", "2x2"}
    assert res["meshes"]["4x1"]["sweep_chains_off"] == 0
    assert res["meshes"]["4x1"]["pt_replicas_off"] == 0
