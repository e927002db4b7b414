"""User-supplied analytic gradients on the port (examples/custom_gradient_nuts.py).

The reference lets a target override ``unnorm_logp_and_grad`` to bypass
autodiff (distributions.rs:83-90); the JAX example attaches a
``jax.custom_vjp`` rule to its logp.  The port's counterpart is the
target's ``unnorm_logp_grad`` hook: every gradient sampler obtains its
gradients through ``as_value_and_grad(target)``
(``general_mcmc_torch/models/distributions.py``), which takes the hook where
the target has one and autograd of ``unnorm_logp`` only where it has none.

Use cases: gradients cheaper than autograd (precomputed factorizations),
numerically-stabilized gradients near singular points, or gradients of
log densities autograd cannot trace (custom C++/CUDA calls).
"""

import numpy as np
import torch

from general_mcmc_torch import NUTS, init_det
from general_mcmc_torch.models.distributions import as_value_and_grad


class CustomGaussian:
    """Diagonal-Gaussian logp with a HAND-CODED gradient."""

    def __init__(self, mean, inv):
        self.mean, self.inv = mean, inv

    def to(self, device=None, dtype=None):
        return CustomGaussian(self.mean.to(device=device, dtype=dtype),
                              self.inv.to(device=device, dtype=dtype))

    def unnorm_logp(self, x):
        d = x - self.mean
        return -0.5 * (d * self.inv * d).sum(dim=-1)

    def unnorm_logp_grad(self, x):
        # the exact gradient, computed our way (no autograd tape)
        return -self.inv * (x - self.mean)


def make_custom_gaussian(mean, cov_diag):
    mean = torch.as_tensor(mean)
    return CustomGaussian(mean, 1.0 / torch.as_tensor(cov_diag, dtype=mean.dtype))


def main(n_chains=64, n_collect=400, n_warmup=200, seed=0, device=None):
    mean = np.array([1.0, -2.0, 3.0], np.float32)
    var = np.array([0.5, 2.0, 4.0], np.float32)
    logp = make_custom_gaussian(mean, var)

    # Prove the hook is what the samplers will use: as_value_and_grad (the
    # transform NUTS/HMC apply) must return the hand-coded formula.
    x0 = torch.tensor([[0.3, 0.7, -1.1]])
    val, grad = as_value_and_grad(logp)(x0)
    np.testing.assert_allclose(grad[0].numpy(), -(x0[0].numpy() - mean) / var, rtol=1e-6)

    sampler = NUTS(logp, init_det(n_chains, 3, device=device), 0.8, seed=seed, device=device)
    sample, stats = sampler.run_progress(n_collect, n_warmup, progress=False)
    print(stats)
    flat = sample.cpu().numpy().reshape(-1, 3)
    print("posterior mean:", flat.mean(axis=0), " (target:", mean, ")")
    print("posterior var :", flat.var(axis=0), " (target:", var, ")")
    return sample, stats


if __name__ == "__main__":
    main()
