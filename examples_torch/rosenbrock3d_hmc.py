"""Batched HMC on the 3-D Rosenbrock density with a 3-D scatter plot and
wall-clock timing, on the port (examples/rosenbrock3d_hmc.py,
examples/rosenbrock3d_hmc.rs).  ``Timer.log(block_on=sample)`` waits for
the card before it reads the clock.  Without matplotlib the samples are
written as CSV instead of the plot."""

import os

from _figure import save_figure
from general_mcmc_torch import HMC, RosenbrockND, init_det
from general_mcmc_torch.utils import Timer

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


def main(n_collect=1_000, burnin=100, n_chains=6, seed=42, device=None):
    sampler = HMC(RosenbrockND(), init_det(n_chains, 3, device=device), step_size=0.01,
                  n_leapfrog=50, device=device).set_seed(seed)
    timer = Timer()
    sample = sampler.run(n_collect, burnin)
    timer.log(f"HMC: {n_chains}×{n_collect} samples of 3-D Rosenbrock", block_on=sample)
    pooled = sample.cpu().numpy().reshape(-1, 3)

    os.makedirs(OUT_DIR, exist_ok=True)

    def draw(plt):
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(pooled[:, 0], pooled[:, 1], pooled[:, 2], s=3, alpha=0.3)
        ax.set_title("HMC samples from the 3-D Rosenbrock density")
        return fig

    return save_figure(os.path.join(OUT_DIR, "rosenbrock3d_hmc.png"), draw, pooled)


if __name__ == "__main__":
    main()
