"""JAX's ChEES at German credit's shape on the CPU: the reference beside
``port_scripts/chees_german_spread.py``, which runs the port's ChEES on the
same inputs.

The data and the initial positions are the port's, handed to JAX as numpy:
``make_logistic_data(7, 1000, 24)`` and ``init_with_seed(--chains, 26,
--seed)``.  ``general_mcmc_tpu``'s ``ChEESHMC`` then runs on the
non-centred ``HierarchicalLogisticNC`` with chip_smoke.py's settings for
that phase (target accept 0.95, jitter 1.0, static collection, seed
``--seed``), 512 warmup and 512 collected steps, in float32.  It prints
the spread witness that ``chip_smoke.german_posterior`` prints for the
port: the pooled collection's sd over the last draws' (raw and mapped to
(mu, log tau, beta)), the mapped spread by quarter of the collection, the
draws past ``LGG_FAR`` of the last draws' sds (their count, chains, steps
and log densities below the median last draw's), and the divergences.

    JAX_PLATFORMS=cpu python3 port_scripts/chees_german_spread_jax.py \
        [--chains 2560] [--seed 0]

Run from the repo root; no card is needed (about 2 minutes at 2,560
chains on 8 CPU cores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# chip_smoke.py's German credit settings ("logistic-german")
OBS, FEATURES, DATA_SEED = 1000, 24, 7
WARMUP, COLLECT = 512, 512
ACCEPT, JITTER = 0.95, 1.0
FAR = 6.0


def spread_witness(draws, mapped, lp, divergences):
    """The witness of ``chip_smoke.german_posterior`` from numpy arrays:
    ``draws`` and ``mapped`` ``[chains, steps, dim]``, ``lp`` the log
    densities ``[chains, steps]``, ``divergences`` per chain."""
    import numpy as np

    draws, mapped = draws.astype(np.float64), mapped.astype(np.float64)
    last, last_mapped = draws[:, -1], mapped[:, -1]
    ref_mean, ref_std = last_mapped.mean(0), last_mapped.std(0, ddof=1)
    n, steps, d = draws.shape
    quarters = mapped.reshape(n, 4, steps // 4, d)
    quarter_std = quarters.transpose(1, 0, 2, 3).reshape(4, -1, d).std(axis=1)
    pooled_std = draws.reshape(-1, d).std(0)
    pooled_mapped_std = mapped.reshape(-1, d).std(0)
    far = np.abs((mapped - ref_mean) / ref_std).max(axis=-1) > FAR
    far_chains, far_steps = np.nonzero(far)
    median_lp = float(np.median(lp[:, -1]))
    far_lp = lp[far]
    diverging = set(np.nonzero(divergences > 0)[0].tolist())
    far_set = set(far_chains.tolist())
    return dict(
        pooled_over_last_sd=round(float((pooled_std / last.std(0, ddof=1)).max()), 4),
        pooled_over_last_mapped_sd=round(float((pooled_mapped_std / ref_std).max()), 4),
        quarter_over_last_mapped_sd=[round(float(v), 4) for v in (quarter_std / ref_std).max(1)],
        far_draws=int(far.sum()), far_chains=len(far_set),
        far_steps=[int(far_steps.min()), int(far_steps.max())] if far_set else [],
        far_lp_below_median=(round(median_lp - float(far_lp.max()), 2),
                             round(median_lp - float(far_lp.min()), 2)) if far_set else (),
        divergences=int(divergences.sum()), chains_diverging=len(diverging),
        far_chains_diverging=len(far_set & diverging))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=2560, help="ChEES's chains")
    ap.add_argument("--seed", type=int, default=0, help="initial positions' and draws' seed")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import general_mcmc_torch as port
    from general_mcmc_tpu.models.regression import HierarchicalLogisticNC
    from general_mcmc_tpu.samplers.chees import ChEESHMC

    X, y, _ = port.make_logistic_data(DATA_SEED, OBS, FEATURES, device="cpu")
    x0 = port.init_with_seed(args.chains, FEATURES + 2, args.seed, device="cpu")
    target = HierarchicalLogisticNC(jnp.asarray(X.numpy()), jnp.asarray(y.numpy()))
    sampler = ChEESHMC(target, jnp.asarray(x0.numpy()), target_accept_p=ACCEPT,
                       jitter_amount=JITTER, static_collection=True, seed=args.seed)
    t0 = time.perf_counter()
    draws = np.asarray(jax.block_until_ready(sampler.run(COLLECT, WARMUP)))
    wall = time.perf_counter() - t0
    mapped = np.concatenate([draws[..., :2], np.asarray(target.beta(jnp.asarray(draws)))],
                            axis=-1)
    lp = np.asarray(jax.vmap(jax.vmap(target.unnorm_logp))(jnp.asarray(draws)))
    witness = spread_witness(draws, mapped, lp, np.asarray(sampler.divergences))
    print(json.dumps({"framework": "jax", "device": "cpu", "chains": args.chains,
                      "seed": args.seed, "eps_bar": float(sampler.adapted_step_size),
                      "finite": bool(np.isfinite(draws).all()), **witness,
                      "wall_s": round(wall, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
