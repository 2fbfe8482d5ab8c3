"""bayesfmmm-tpu: accelerator-native Bayesian mixed membership models.

A from-scratch JAX/XLA framework with the capabilities of the
BayesFMMM model family: functional, high-dimensional (tensor-domain), and
multivariate mixed membership models with covariate-adjusted means and
covariances, fit by vectorized Gibbs-within-Metropolis MCMC (with tempered
transitions, replica-exchange parallel tempering, SMC), whole-model HMC,
and ADVI — chain-parallel over device meshes.

Quick start::

    import jax, jax.numpy as jnp
    from bayesfmmm_tpu import api
    from bayesfmmm_tpu.models.state import make_functional_data

    data = make_functional_data(y_list, t_list, basis_degree=3,
                                internal_knots=knots, boundary_knots=bounds)
    result = api.fit(data=data, K=2, M=3)
    est = result.estimates()

Reference-compatible surface: ``from bayesfmmm_tpu import reference_api``
exposes all 33 function names of the original R package (FMeanCI, FDIC,
BFMMM_warm_start, ...) over the same trace-file contract.
"""

__version__ = "0.1.0"

from bayesfmmm_tpu.config import ModelConfig, Priors, SamplerConfig  # noqa: F401


def __getattr__(name):
    # Lazy submodule access keeps `import bayesfmmm_tpu` light (no jax init).
    import importlib
    if name in ("api", "basis", "diagnostics", "reference_api"):
        return importlib.import_module(f"bayesfmmm_tpu.{name}")
    raise AttributeError(name)
