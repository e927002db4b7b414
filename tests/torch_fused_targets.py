"""The repo's continuous targets that the fused kernels take, on both sides:
the JAX package's target, the port's target kind and parameters, a small
width, a step size and leapfrogs (tests/test_torch_fused_targets*.py)."""

import jax.numpy as jnp
import numpy as np

import general_mcmc_tpu as gmt
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_torch.convert import to_target

RTOL = 1e-10  # float64, the same formulas and draws: rounding only
MEAN2, COV2 = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])


def dense_cov(d):
    """``D R D`` with the headline's scales and ``R_ij = 0.5^|i−j|``."""
    scales = np.exp(np.linspace(0.0, np.log(10.0), d))
    idx = np.arange(d)
    return scales[:, None] * 0.5 ** np.abs(idx[:, None] - idx[None, :]) * scales[None, :]


def logistic_data(n_obs=32, p=6, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, p))
    beta = 0.5 * rng.normal(size=p)
    y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, y


def targets():
    """name -> (JAX target, the port's target kind and parameters, width,
    step size, leapfrogs): every target the fused kernels take beyond the
    diagonal GaussianND, at small widths."""
    X, y = logistic_data()
    cov4 = dense_cov(4)
    return {
        "diffable2d": (gmt.DiffableGaussian2D(mean=jnp.asarray(MEAN2), cov=jnp.asarray(COV2)),
                       ("DiffableGaussian2D", MEAN2, COV2), 2, 0.25, 5),
        "gaussian2d": (gmt.Gaussian2D(mean=jnp.asarray(MEAN2), cov=jnp.asarray(COV2)),
                       ("Gaussian2D", MEAN2, COV2), 2, 0.25, 5),
        "rosenbrock2d": (gmt.Rosenbrock2D(1.0, 10.0), ("Rosenbrock2D", 1.0, 10.0), 2, 0.05, 5),
        "rosenbrock_nd": (gmt.RosenbrockND(), ("RosenbrockND",), 5, 0.01, 5),
        "funnel": (gmt.NealsFunnel(6), ("NealsFunnel", 6, 3.0), 6, 0.2, 5),
        "dense_gaussian": (gmt.GaussianND(mean=jnp.zeros(4), cov=jnp.asarray(cov4)),
                           ("GaussianND", np.zeros(4), cov4), 4, 0.2, 5),
        "logistic_nc": (JaxLogisticNC(jnp.asarray(X), jnp.asarray(y)),
                        ("HierarchicalLogisticNC", X, y), 8, 0.05, 5),
    }


def port_target(spec, dtype):
    kind, *params = spec
    return to_target(kind, *params, dtype=dtype)


LAYOUTS = [(10, 4, 1), (5, 3, 3), (6, 0, 2)]  # tests/test_torch_fused_hmc.py's cases
