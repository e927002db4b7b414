"""Post-warmup divergences of ChEES-HMC on the stretch line's data, in the
JAX package or in the PyTorch port, on the CPU.

The stretch line is bench.py's (bench.py:737-760): ``HierarchicalLogisticNC``
on ``make_logistic_data(PRNGKey(1), 256, 48)``, ``ChEESHMC(target_accept_p
=0.95, jitter_amount=1.0, static_collection=True, seed=0)``, 256 warmup and
1,024 collected steps.  The JAX side draws the data with the JAX package;
the port's side reads the same arrays from the file the port ships
(``general_mcmc_torch/data/bench_logistic_k1.npz``).  Each side prints one
JSON line: the chain count, the post-warmup divergences summed over chains,
the transitions they fall in, the rate, its exact Poisson 95% interval, how
many chains diverged at least once and the most any one did, the adapted
step size, trajectory length and L, and the wall.

``--data torch`` runs both sides instead on the data the port's stretch line
used before it read JAX's: the port's ``make_logistic_data(1, 256, 48)``
(a seeded torch generator), handed to JAX as numpy.  ``--device cuda`` runs
the port's side on the card.

    JAX_PLATFORMS=cpu python port_scripts/stretch_divergences.py jax --chains 1024
    python port_scripts/stretch_divergences.py torch --chains 1024
    python port_scripts/stretch_divergences.py torch --chains 10240 --device cuda

Run from the repo root (it puts the root on ``sys.path``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WARMUP, COLLECT, DIM, N_OBS = 256, 1024, 50, 256
SETTINGS = dict(target_accept_p=0.95, jitter_amount=1.0, static_collection=True, seed=0)


def poisson_interval(k: int, level: float = 0.95) -> tuple[float, float]:
    """The exact (Garwood) interval of a Poisson mean from ``k`` events."""
    from scipy.stats import chi2

    a = 1.0 - level
    lo = 0.0 if k == 0 else chi2.ppf(a / 2, 2 * k) / 2
    return lo, chi2.ppf(1 - a / 2, 2 * k + 2) / 2


def torch_data():
    """The port's ``make_logistic_data(1, 256, 48)`` as numpy."""
    from general_mcmc_torch import make_logistic_data

    X, y, _ = make_logistic_data(1, N_OBS, DIM - 2, device="cpu")
    return X.numpy(), y.numpy()


def run_jax(n_chains: int, data: str, device: str):
    import jax
    import jax.numpy as jnp

    from general_mcmc_tpu import ChEESHMC, init_with_seed
    from general_mcmc_tpu.models.regression import HierarchicalLogisticNC, make_logistic_data

    if data == "jax":
        X, y, _ = make_logistic_data(jax.random.PRNGKey(1), N_OBS, DIM - 2)
    else:
        X, y = (jnp.asarray(a) for a in torch_data())
    s = ChEESHMC(HierarchicalLogisticNC(X, y), init_with_seed(n_chains, DIM, 0), **SETTINGS)
    t0 = time.perf_counter()
    samples = s.run(COLLECT, WARMUP)
    jax.block_until_ready(samples)
    wall = time.perf_counter() - t0
    per_chain = [int(v) for v in jax.device_get(s.divergences)]
    return (per_chain, float(s.adapted_step_size), float(s.adapted_trajectory_length),
            int(s._static_L), wall)


def run_torch(n_chains: int, data: str, device: str):
    import torch

    from general_mcmc_torch import ChEESHMC, HierarchicalLogisticNC, init_with_seed
    from general_mcmc_torch.models.regression import bench_logistic_data

    if data == "jax":
        X, y, _ = bench_logistic_data(device=device)
    else:
        X, y = (torch.from_numpy(a).to(device) for a in torch_data())
    s = ChEESHMC(HierarchicalLogisticNC(X, y), init_with_seed(n_chains, DIM, 0, device=device),
                 device=device, **SETTINGS)
    t0 = time.perf_counter()
    with torch.no_grad():
        s.run(COLLECT, WARMUP)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    per_chain = s.divergences.cpu().tolist()
    return (per_chain, float(s.adapted_step_size), float(s.adapted_trajectory_length),
            int(s._static_L), wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("side", choices=("jax", "torch"))
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--data", choices=("jax", "torch"), default="jax")
    ap.add_argument("--device", default="cpu", help="the port's side only")
    a = ap.parse_args(argv)
    if a.side == "jax" and a.device != "cpu":
        ap.error("the JAX side runs on the CPU here")
    per_chain, eps, t_len, L, wall = (run_jax if a.side == "jax" else run_torch)(
        a.chains, a.data, a.device)
    div = sum(per_chain)
    transitions = a.chains * COLLECT
    lo, hi = poisson_interval(div)
    device = a.device
    if device != "cpu":
        import torch

        device = torch.cuda.get_device_name(0)
    print(json.dumps(dict(side=a.side, data=a.data, chains=a.chains,
                          steps=f"{WARMUP}+{COLLECT}", divergences=div,
                          transitions=transitions, rate=div / transitions,
                          rate_95=[lo / transitions, hi / transitions],
                          chains_diverging=sum(v > 0 for v in per_chain),
                          most_in_a_chain=max(per_chain), eps_bar=eps, T=t_len, L=L,
                          wall_s=round(wall, 2), device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
