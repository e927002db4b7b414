"""The ported examples' figures: drawn with matplotlib where it imports,
else the figure's data written as CSV through the port's exporter.

Only the output file differs: the sampling ran on its device either way."""

from __future__ import annotations

import os

import numpy as np

from general_mcmc_torch.io import save_csv


def save_figure(plot_path: str, draw, data) -> str:
    """Call ``draw(plt)`` and save the figure at ``plot_path`` where
    matplotlib imports; else write ``data`` (a ``[rows, columns]`` array:
    the figure's points or bars) as CSV beside it, one chain of ``rows``
    observations.  Prints which it did and returns the path written."""
    try:
        import matplotlib
    except ImportError:
        csv_path = os.path.splitext(plot_path)[0] + ".csv"
        save_csv(np.asarray(data, dtype=np.float64)[None], csv_path)
        print(f"matplotlib unavailable; wrote the figure's data to {csv_path}")
        return csv_path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = draw(plt)
    fig.savefig(plot_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    print(f"matplotlib drew {plot_path}")
    return plot_path
