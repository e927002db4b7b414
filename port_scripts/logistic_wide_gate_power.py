"""What "logistic-wide"'s gate on K3 can see: the chains off the float64
plain version over seeds 0-3 at 64 steps, for the float32 plain version and
for densities with a fault of the kind a streamed kernel could make, at each
case of the phase (chip_smoke.py's LGW_CASES, LGW_CHAINS chains from its
positions, the random walk LGW_WALK / sqrt(n_obs p), data at LGW_SEED).

A K3 position depends on the density only through the accept decisions, so
"bit-equal on the chains whose decisions agree" holds for any density; the
gate that can fail a wrong density is the count of chains off the float64
plain version (at most the float32 plain version's + KL_OFF_SLACK over the
four seeds).  Each fault here is a target whose log-likelihood is the plain
one with a change (the plain ``"torch"`` step runs it, on the CPU):

    drop-32       the last 32 observations left out (a pass of a panel)
    drop-panel    the last panel of the phase's layout left out (the
                  panel rows K3's host code gave each case on the card)
    panel-twice   the first panel counted twice

    PYTHONPATH=. python3 port_scripts/logistic_wide_gate_power.py

Runs on the CPU in about four minutes with four threads.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import general_mcmc_torch as gmt  # noqa: E402
from general_mcmc_torch.ops import fused_mh  # noqa: E402

# chip_smoke.py's "logistic-wide" settings
CASES = ((800, 24), (10_000, 24), (4096, 48), (1024, 100), (1024, 256), (256, 48))
CHAINS, STEPS, SEED, WALK, SEEDS = 512, 64, 3, 0.5, (0, 1, 2, 3)
# K3's panel rows at each case on the card (launch_layout in chip_smoke.py's
# "logistic-wide"); 256 x 48 is resident, and there a "panel" is a pass of
# the tile's two warps, 64 observations
PANEL_ROWS = {(800, 24): 224, (10_000, 24): 256, (4096, 48): 160, (1024, 100): 32,
              (1024, 256): 32, (256, 48): 64}


def faulty(base, a: int, b: int, sign: float):
    """``base``'s class with observations [a, b) added ``sign`` more times
    to the log-likelihood."""

    class Faulty(base):
        def _loglik(self, beta):
            logits = beta @ self.X[a:b].mT
            part = torch.sum(self.y[a:b] * logits - F.softplus(logits), dim=-1)
            return super()._loglik(beta) + sign * part

    return Faulty


def accept_history(samples, x0):
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


def main() -> None:
    torch.set_num_threads(4)
    for n_obs, p in CASES:
        X, y, _ = gmt.make_logistic_data(SEED, n_obs, p, device="cpu")
        x0 = gmt.init_with_seed(CHAINS, p + 2, 2, device="cpu") / math.sqrt(p)
        x0[:, 1] -= 1.0
        x0 = x0.contiguous()
        walk = gmt.RandomWalkProposal(WALK / math.sqrt(n_obs * p))
        rows = PANEL_ROWS[(n_obs, p)]
        for kind, base in (("nc", gmt.HierarchicalLogisticNC), ("centred", gmt.HierarchicalLogistic)):
            targets = {"plain": base(X, y),
                       "drop-32": faulty(base, n_obs - 32, n_obs, -1.0)(X, y),
                       "drop-panel": faulty(base, n_obs - rows, n_obs, -1.0)(X, y),
                       "panel-twice": faulty(base, 0, rows, 1.0)(X, y)}
            target64 = base(X, y).to(dtype=torch.float64)
            off = {name: [] for name in targets}
            for seed in SEEDS:
                h64 = accept_history(fused_mh.fused_mh_run_reference(
                    target64, x0.double(), walk, STEPS, 0, seed=seed), x0.double())
                for name, target in targets.items():
                    run = fused_mh.fused_mh_run_reference(target, x0, walk, STEPS, 0, seed=seed)
                    off[name].append(int((accept_history(run, x0) != h64).any(dim=1).sum()))
            print(json.dumps({"case": f"{n_obs}x{p}", "target": kind, "panel_rows": rows,
                              "off_f64": off}), flush=True)


if __name__ == "__main__":
    main()
