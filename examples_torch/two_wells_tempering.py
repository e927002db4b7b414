"""Replica-exchange sampling of a two-well mixture on the port
(examples/two_wells_tempering.py).

Every chain starts deep in the LEFT well.  Plain random-walk MH essentially
never crosses the barrier; the tempered ensemble recovers the 50/50 mode
mass through even-odd swap rounds.  Draws the two histograms where
matplotlib imports, else writes both chains' draws as CSV.
"""

import os

import numpy as np
import torch

from _figure import save_figure
from general_mcmc_torch import (
    IsotropicGaussian,
    MetropolisHastings,
    ReplicaExchange,
    geometric_temperatures,
)

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


def two_wells(x):
    a = -0.5 * ((x + 4.0) ** 2).sum(dim=-1) / 0.25
    b = -0.5 * ((x - 4.0) ** 2).sum(dim=-1) / 0.25
    return torch.logaddexp(a, b)


def main(device=None):
    os.makedirs(OUT_DIR, exist_ok=True)
    init = np.full((16, 1), -4.0, np.float32)

    mh = MetropolisHastings(two_wells, IsotropicGaussian(0.5), init, device=device).seed(0)
    trapped = mh.run(2000, 300).cpu().numpy().reshape(-1)

    ladder = geometric_temperatures(6, 64.0, device=device)
    pt = ReplicaExchange(two_wells, init, ladder, scale=0.5, device=device).seed(0)
    mixed, stats = pt.run_progress(2000, 300, progress=False)
    mixed = mixed.cpu().numpy().reshape(-1)

    print(f"plain MH right-mode mass:     {(trapped > 0).mean():.3f}")
    print(f"tempered right-mode mass:     {(mixed > 0).mean():.3f} (target 0.5)")
    print(stats)

    def draw(plt):
        fig, axes = plt.subplots(1, 2, figsize=(9, 3), sharey=True)
        for ax, data, title in (
            (axes[0], trapped, "plain MH (trapped)"),
            (axes[1], mixed, "replica exchange"),
        ):
            ax.hist(data, bins=80, density=True)
            ax.set_title(title)
        return fig

    save_figure(os.path.join(OUT_DIR, "two_wells_tempering.png"), draw,
                np.stack([trapped, mixed], axis=1))
    return (trapped > 0).mean(), (mixed > 0).mean()


if __name__ == "__main__":
    main()
