"""How the fused logistic kernels' gates at German credit's shape depend on
the run's settings, on one card: the evidence for the step sizes and the
thinning that chip_smoke.py's "logistic-german" uses.

At German credit's shape (chip_smoke.py's ``german_posterior``: ChEES's
posterior of ``make_logistic_data(7, 1000, 24)`` at 10,240 chains), from
ChEES's last draws, in the metric it adapts (the centred target: the mapped
draws' variance):

- K1 (``HMC(backend="cuda")``, L 10) at each factor of ChEES's ε̄: the
  accept of ``run(1000, 200)``, its max split-R-hat and the coordinate where
  it peaks, unthinned and thinned by 4; the kernel against its float32
  plain version after 1, 8 and 64 steps (max|Δ|/max|θ| over the chains whose
  accept histories agree, and the chains that differ); the float32 plain
  version and the kernel each against the float64 plain version at 64
  steps; the chains off the float64 plain version over seeds 0-3, the
  kernel's and the float32 plain version's.
- K3 (``MetropolisHastings(backend="cuda")``, the random walk 2.38/sqrt(26)
  x the least posterior sd): the card ms, max split-R-hat and its
  coordinate of ``run(2000, 500, thin=T)`` at each (chains, T).

    python3 port_scripts/logistic_german_scan.py

Run from the repo root on a machine with one CUDA card and ``nvcc``; one
JSON line a setting.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K1_FACTORS = {"nc": (1.0, 1.25, 1.5, 2.0), "centred": (2.5, 3.0)}
K3_RUNS = ((10_240, 60), (10_240, 250), (2_560, 400))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    history = cs.accept_history
    print(json.dumps({"card": cs.nvidia_smi_line()}), flush=True)
    chees, targets = cs.german_posterior(dev)
    print(json.dumps(chees), flush=True)

    def rel(got, want, x0):
        same = (history(got, x0) == history(want, x0)).all(dim=1)
        err = (got[same].double() - want[same].double()).abs().max() / want[same].abs().max()
        return float(err), int((~same).sum())

    for kind, factors in K1_FACTORS.items():
        target, mass_inv, x0, _, _ = targets[kind]
        minv = mass_inv.to(dev)
        t64, x64, m64 = target.to(dtype=torch.float64), x0.double(), minv.double()
        for factor in factors:
            eps = factor * chees["eps_bar"]
            out = dict(kernel="K1", kind=kind, factor=factor, eps=eps)
            for thin in (1, 4):
                s = gmt.HMC(target, x0, eps, 10, seed=0, mass_inv=minv,
                            backend="cuda").run(1000, 200, thin=thin)
                rhat, _ = gmt.split_rhat_mean_ess(s.transpose(0, 1), steps_major=True)
                if thin == 1:
                    out["accept"] = round(cs.moved_share(s), 4)
                out[f"max_rhat_thin{thin}"] = round(float(rhat.max()), 5)
                out[f"rhat_at_thin{thin}"] = int(rhat.argmax())
                del s
            run = lambda steps, seed=0: fused_hmc.fused_hmc_run(
                target, x0, eps, 10, steps, 0, seed=seed, mass_inv=minv)
            plain = lambda steps, seed=0: fused_hmc.fused_hmc_run_reference(
                target, x0, eps, 10, steps, 0, seed=seed, mass_inv=minv)
            plain64 = lambda steps, seed=0: fused_hmc.fused_hmc_run_reference(
                t64, x64, eps, 10, steps, 0, seed=seed, mass_inv=m64)
            for steps in (1, 8, 64):
                out[f"rel_{steps}"], out[f"differ_{steps}"] = rel(run(steps), plain(steps), x0)
            w64 = plain64(64)
            out["plain_vs_f64_rel_64"] = rel(plain(64), w64, x0)[0]
            out["kernel_vs_f64_rel_64"] = rel(run(64), w64, x0)[0]
            off = {"kernel": [], "plain": []}
            for seed in range(4):
                h64 = history(plain64(64, seed), x64)
                for name, fn in (("kernel", run), ("plain", plain)):
                    off[name].append(int((history(fn(64, seed), x0) != h64).any(dim=1).sum()))
            out["off_f64_kernel"], out["off_f64_plain_f32"] = off["kernel"], off["plain"]
            print(json.dumps(out), flush=True)

    for kind in ("nc", "centred"):
        target, _, last, _, std = targets[kind]
        d = last.shape[1]
        walk = gmt.RandomWalkProposal(cs.two_figures_down(2.38 / math.sqrt(d) * float(std.min())))
        for n, thin in K3_RUNS:
            x0 = last[:n].contiguous()
            ms, _, g = cs.timed(lambda: gmt.MetropolisHastings(
                target, walk, x0, seed=0, backend="cuda").run(2000, 500, thin=thin), 1)
            rhat, _ = gmt.split_rhat_mean_ess(g.transpose(0, 1), steps_major=True)
            del g
            print(json.dumps(dict(kernel="K3", kind=kind, chains=n, thin=thin, ms=round(ms, 1),
                                  max_rhat=round(float(rhat.max()), 5),
                                  rhat_at=int(rhat.argmax()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
