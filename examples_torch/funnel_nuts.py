"""Neal's funnel under NUTS on the port: divergence diagnostics in action
(examples/funnel_nuts.py).

The funnel's neck defeats fixed-step integrators; NUTS flags those
trajectories as divergences (the Δ > 1000 check, generic_nuts.rs:1199).
This example contrasts a coarse fixed step (many divergences — results
untrustworthy near the neck) with dual-averaged adaptation (few).  Without
matplotlib the plotted points are written as CSV instead of the plot.
"""

import os

from _figure import save_figure
from general_mcmc_torch import NUTS, NealsFunnel, init_with_seed

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


def main(n_chains=64, dim=8, n_collect=400, n_warmup=400, seed=0, device=None):
    funnel = NealsFunnel(dim=dim)
    inits = 0.5 * init_with_seed(n_chains, dim, seed, device=device)

    coarse = NUTS(funnel, inits, step_size=1.0, max_tree_depth=8, seed=seed, device=device)
    coarse.run(n_collect, 0)
    div_coarse = int(coarse.divergences.sum())

    adapted = NUTS(funnel, inits, target_accept_p=0.9, max_tree_depth=8, seed=seed,
                   device=device)
    s_adapted = adapted.run(n_collect, n_warmup)
    div_adapted = int(adapted.divergences.sum())

    total = n_chains * n_collect
    print(f"fixed ε=1.0:   {div_coarse} divergent transitions / {total}")
    print(f"dual-averaged: {div_adapted} divergent transitions / {total}")

    os.makedirs(OUT_DIR, exist_ok=True)
    flat = s_adapted.cpu().numpy().reshape(-1, dim)
    points = flat[:, [0, -1]]

    def draw(plt):
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(points[:, 0], points[:, 1], s=3, alpha=0.25)
        ax.set_xlabel("x₁")
        ax.set_ylabel("v (log-scale parameter)")
        ax.set_title("NUTS samples from Neal's funnel (adapted ε)")
        return fig

    plot_path = save_figure(os.path.join(OUT_DIR, "funnel_nuts.png"), draw, points)
    return div_coarse, div_adapted, plot_path


if __name__ == "__main__":
    main()
