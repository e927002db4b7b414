"""Gibbs sampling of a two-component Gaussian mixture with a histogram
plot, on the port (examples/mixture_gibbs.py, examples/mixture_gibbs.rs).

State is [x, z]: x | z ~ N(μ_z, σ_z²); z | x from the posterior odds.  The
JAX example's conditional ``sample(key, i, state)`` draws from its own key
for one chain; the port's is keyless and batched, ``sample(draws, i, state
[n, dim]) -> [n]``, with coordinate ``i``'s normals and uniforms in
``draws`` (``general_mcmc_torch/samplers/gibbs.py``).  Without matplotlib
the draws of x are written as CSV instead of the histogram.
"""

import dataclasses
import math
import os

import numpy as np
import torch

from _figure import save_figure
from general_mcmc_torch import GibbsSampler, init_det

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


@dataclasses.dataclass(frozen=True, eq=False)
class MixtureConditional:
    mu0: float = -2.0
    sigma0: float = 1.0
    mu1: float = 3.0
    sigma1: float = 1.5
    pi0: float = 0.4

    def _pdf(self, x, mu, sigma):
        var = sigma * sigma
        return torch.exp(-((x - mu) ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)

    def sample(self, draws, i, state):
        if i == 0:
            z = state[:, 1]
            eps = draws.normal(0)
            return torch.where(
                z < 0.5, self.mu0 + self.sigma0 * eps, self.mu1 + self.sigma1 * eps
            )
        x = state[:, 0]
        p0 = self.pi0 * self._pdf(x, self.mu0, self.sigma0)
        p1 = (1 - self.pi0) * self._pdf(x, self.mu1, self.sigma1)
        prob_z1 = torch.where(p0 + p1 > 0, p1 / (p0 + p1), 0.5)
        return (draws.uniform(0) < prob_z1).to(state.dtype)


def main(n_collect=20_000, burnin=2_000, n_chains=4, seed=42, device=None):
    cond = MixtureConditional()
    x0 = init_det(n_chains, 1, device=device)
    inits = torch.cat([x0, torch.zeros_like(x0)], dim=1)
    sampler = GibbsSampler(cond, inits, device=device).set_seed(seed)
    sample, stats = sampler.run_progress(n_collect, burnin)
    x = sample[:, :, 0].reshape(-1).cpu().numpy()
    print(f"Mixture Gibbs: {len(x)} samples, mean={x.mean():.3f}, var={x.var():.3f}")
    print(stats)

    os.makedirs(OUT_DIR, exist_ok=True)

    def draw(plt):
        grid = np.linspace(-7, 9, 400)
        c = cond
        density = c.pi0 * np.exp(-((grid - c.mu0) ** 2) / (2 * c.sigma0**2)) / (
            c.sigma0 * math.sqrt(2 * math.pi)
        ) + (1 - c.pi0) * np.exp(-((grid - c.mu1) ** 2) / (2 * c.sigma1**2)) / (
            c.sigma1 * math.sqrt(2 * math.pi)
        )
        fig, ax = plt.subplots(figsize=(7, 5))
        ax.hist(x, bins=80, density=True, alpha=0.6, color="steelblue", label="Gibbs")
        ax.plot(grid, density, "k-", lw=1.5, label="true density")
        ax.legend()
        ax.set_title("Gibbs sampling of a Gaussian mixture")
        return fig

    return save_figure(os.path.join(OUT_DIR, "mixture_gibbs_hist.png"), draw, x[:, None])


if __name__ == "__main__":
    main()
