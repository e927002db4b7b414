"""Discrete MH on a Poisson(λ) target with a frequency bar chart, on the
port (examples/poisson_mh.py, examples/poisson_mh.rs).

Uses the nonnegative random-walk proposal: from 0 always propose 1; from
x > 0 propose x±1 with probability ½ each — an asymmetric proposal whose
forward/backward densities enter the acceptance ratio.  The JAX example's
``sample(key, current)`` draws its own coin; the port has no keys, so the
proposal is the reparameterized pair ``propose(x, up)`` / ``logp(from,
to)`` over the batch, and ``draws = "sign"`` asks the sampler for the
coin flips ``up`` (``general_mcmc_torch/samplers/metropolis_hastings.py``).
Without matplotlib the bars' data are written as CSV instead of the chart.
"""

import dataclasses
import math
import os

import numpy as np
import torch

from _figure import save_figure
from general_mcmc_torch import MetropolisHastings, Poisson

OUT_DIR = os.environ.get("EXAMPLE_OUT", "example_outputs")


@dataclasses.dataclass(frozen=True, eq=False)
class NonnegativeWalkProposal:
    """0 → 1 with certainty; x → x±1 with probability ½ (poisson_mh.rs:31-75)."""

    symmetric = False
    draws = "sign"  # a fair coin flip a coordinate a step

    def propose(self, current, up):
        """``current [n, 1]`` integer states, ``up [n, 1]`` coin flips."""
        step = torch.where(up, 1, -1).to(current.dtype)
        return torch.where(current == 0, torch.ones_like(current), current + step)

    def logp(self, from_, to):
        """``log q(from → to)`` for ``[n, 1]`` states: ``[n]`` float32."""
        x, y = from_[:, 0], to[:, 0]
        zero = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        ln_half = torch.full_like(zero, math.log(0.5))
        never = torch.full_like(zero, -math.inf)
        from_zero = torch.where(y == 1, zero, never)
        from_pos = torch.where((y - x).abs() == 1, ln_half, never)
        return torch.where(x == 0, from_zero, from_pos)


def main(n_collect=5_000, burnin=1_000, n_chains=4, lam=4.0, seed=42, device=None):
    target = Poisson(lam)
    inits = np.full((n_chains, 1), int(lam), np.int32)
    mh = MetropolisHastings(target, NonnegativeWalkProposal(), inits, device=device).seed(seed)
    sample = mh.run(n_collect, burnin)
    ks = sample.cpu().numpy().reshape(-1).astype(int)
    print(f"Poisson MH: {len(ks)} samples, mean={ks.mean():.3f} (λ={lam})")

    k_max = 15
    counts = np.bincount(ks, minlength=k_max + 1)[: k_max + 1]
    freqs = counts / len(ks)
    exact = np.array(
        [math.exp(-lam) * lam**k / math.factorial(k) for k in range(k_max + 1)]
    )

    os.makedirs(OUT_DIR, exist_ok=True)
    kk = np.arange(k_max + 1)

    def draw(plt):
        fig, ax = plt.subplots(figsize=(7, 5))
        ax.bar(kk - 0.2, freqs, width=0.4, label="MH frequency")
        ax.bar(kk + 0.2, exact, width=0.4, label="exact pmf")
        ax.set_xlabel("k")
        ax.legend()
        ax.set_title(f"Discrete MH on Poisson({lam:g})")
        return fig

    return save_figure(os.path.join(OUT_DIR, "poisson_mh_bars.png"), draw,
                       np.stack([kk, freqs, exact], axis=1))


if __name__ == "__main__":
    main()
