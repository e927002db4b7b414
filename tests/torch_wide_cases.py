"""The lane-target cases that hold K1 and K3 on the wide map to their plain
versions bit for bit, shared by ``tests/test_torch_cuda_wide.py`` and
chip_smoke.py's "wide-equal" phase.  No JAX."""

import numpy as np
import torch

from general_mcmc_torch import GaussianND, NealsFunnel, RosenbrockND


def wide_case(name: str, d: int, dev, chains: int, mass: bool = False):
    """The lane target ``name`` ("gaussian", "rosenbrock" or "funnel") at
    width ``d`` on ``dev``: the target, ``chains`` starting positions
    (seeded by the width), HMC's step size and M⁻¹ (the Gaussian's; ``mass``
    sizes the step for it), MH's walk scale and pCN's beta, each scaled so
    that some proposals are taken and some not."""
    rng = np.random.default_rng(d)
    f32 = dict(dtype=torch.float32, device=dev)
    mass_inv = None
    if name == "gaussian":
        scales = np.exp(0.3 * rng.normal(size=d))
        target = GaussianND(rng.normal(size=d), scales, **f32)
        x0 = rng.normal(size=(chains, d)) * scales
        eps = 3 * d**-0.25 * (1.0 if mass else scales.min())
        walk, beta = 2.38 / np.sqrt(d) * scales.min(), 0.05
        mass_inv = torch.as_tensor(scales**2, **f32)
    elif name == "rosenbrock":
        target = RosenbrockND()
        x0 = 0.1 * rng.normal(size=(chains, d))
        eps, walk, beta = 0.01, 0.02 / np.sqrt(d), 0.005
    else:
        target = NealsFunnel(d, 3.0)
        x0 = 0.5 * rng.normal(size=(chains, d))
        eps, walk, beta = 0.15 * d**-0.25, 0.5 / np.sqrt(d), 0.05
    return target, torch.as_tensor(x0, **f32), float(eps), float(walk), beta, mass_inv
