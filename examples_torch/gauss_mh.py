"""2D Gaussian MH demo on the port with a scatter plot and Parquet export
(examples/gauss_mh.py, examples/gauss_mh.rs).

Parquet needs ``pyarrow``; without it ``save_parquet`` raises
``ImportError`` naming it.  The scatter plot needs matplotlib; without it
the scatter's points are written as CSV instead (``_figure.save_figure``).
"""

import os

from _figure import save_figure
from general_mcmc_torch import Gaussian2D, IsotropicGaussian, MetropolisHastings, init_det
from general_mcmc_torch.io import save_parquet

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


def main(sample_size=5_000, burnin=1_000, n_chains=4, seed=42, device=None):
    target = Gaussian2D(mean=[0.0, 0.0], cov=[[2.0, 1.0], [1.0, 2.0]])
    proposal = IsotropicGaussian(2.0)
    mh = MetropolisHastings(target, proposal, init_det(n_chains, 2, device=device),
                            device=device).seed(seed)

    sample, stats = mh.run_progress(sample_size // n_chains, burnin)
    pooled = sample.cpu().numpy().reshape(sample_size, 2)
    print(f"Generated {len(pooled)} samples\n{stats}")
    print(f"Mean after burn-in: ({pooled[:, 0].mean():.2f}, {pooled[:, 1].mean():.2f})")

    os.makedirs(OUT_DIR, exist_ok=True)
    parquet_path = os.path.join(OUT_DIR, "gauss_mh.parquet")
    save_parquet(sample, parquet_path)

    def draw(plt):
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(pooled[:, 0], pooled[:, 1], s=6, alpha=0.4, color="steelblue")
        ax.set_title("MH samples from a correlated 2D Gaussian")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        return fig

    plot_path = save_figure(os.path.join(OUT_DIR, "gauss_mh_scatter.png"), draw, pooled)
    print(f"Wrote {parquet_path} and {plot_path}")
    return parquet_path, plot_path


if __name__ == "__main__":
    main()
