"""Random-walk MH on the 2-D Rosenbrock banana with a density-contour plot,
on the port (examples/rosenbrock_mh.py, examples/rosenbrock_mh.rs).  Without
matplotlib the samples are written as CSV instead of the plot."""

import os

import numpy as np

from _figure import save_figure
from general_mcmc_torch import IsotropicGaussian, MetropolisHastings, Rosenbrock2D, init_det

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


def main(sample_size=8_000, burnin=2_000, n_chains=4, seed=42, device=None):
    target = Rosenbrock2D(a=1.0, b=100.0)
    proposal = IsotropicGaussian(0.5)
    mh = MetropolisHastings(target, proposal, init_det(n_chains, 2, device=device),
                            device=device).seed(seed)
    sample = mh.run(sample_size // n_chains, burnin)
    pooled = sample.cpu().numpy().reshape(-1, 2)
    print(f"Rosenbrock MH: {len(pooled)} samples, mean=({pooled[:,0].mean():.2f}, "
          f"{pooled[:,1].mean():.2f})")

    os.makedirs(OUT_DIR, exist_ok=True)

    def draw(plt):
        xs = np.linspace(-2.5, 2.5, 200)
        ys = np.linspace(-1.0, 5.0, 200)
        xx, yy = np.meshgrid(xs, ys)
        logp = -((1.0 - xx) ** 2 + 100.0 * (yy - xx**2) ** 2)
        fig, ax = plt.subplots(figsize=(7, 6))
        ax.contour(xx, yy, logp, levels=np.quantile(logp, [0.9, 0.97, 0.995, 0.9995]),
                   colors="gray", linewidths=0.8)
        ax.scatter(pooled[:, 0], pooled[:, 1], s=4, alpha=0.3, color="crimson")
        ax.set_title("MH samples on the Rosenbrock banana")
        return fig

    return save_figure(os.path.join(OUT_DIR, "rosenbrock_mh.png"), draw, pooled)


if __name__ == "__main__":
    main()
