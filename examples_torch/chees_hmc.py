"""ChEES-HMC against NUTS on the port (examples/chees_hmc.py).

The reference's answer to "how long should a trajectory be?" is NUTS's
per-chain tree building.  ChEES-HMC (Hoffman, Radul & Sountsov, AISTATS
2021) answers it with *cross-chain* adaptation instead: every iteration
integrates all chains for the same Halton-jittered time, the maximum
trajectory length T ascends the ChEES criterion by Adam, a shared step size
dual-averages on the batch acceptance rate and the diagonal metric comes
from cross-chain variance.  ``static_collection=True`` freezes the leapfrog
count after warmup and jitters the step size instead (Neal 2011 §5.4.3.3).

This miniature runs both samplers on the benchmark's ill-conditioned
Gaussian at 16 dimensions and prints the adapted quantities.
"""

import numpy as np

from general_mcmc_torch import ChEESHMC, NUTS, GaussianND, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.diagnostics.stats import split_rhat_mean_ess

DIM = 16
N_CHAINS = 256


def target():
    scales = np.exp(np.linspace(0.0, np.log(10.0), DIM)).astype(np.float32)
    return GaussianND(mean=np.zeros(DIM, np.float32), cov=scales), scales


def main(device=None):
    tgt, scales = target()

    chees = ChEESHMC(
        tgt,
        init_with_seed(N_CHAINS, DIM, 0, device=device),
        target_accept_p=0.9,
        jitter_amount=0.5,
        static_collection=True,
        seed=0,
        device=device,
    )
    sample = chees.run(400, 300)
    rhat, ess, _mean, std = split_rhat_mean_ess(sample, return_moments=True)
    rhat, ess, std = (t.cpu().numpy() for t in (rhat, ess, std))
    assert tuple(sample.shape) == (N_CHAINS, 400, DIM)
    assert float(rhat.max()) < 1.05
    assert float(np.abs(std / scales - 1.0).max()) < 0.2
    print(
        f"ChEES-HMC: max R-hat {float(rhat.max()):.4f}  "
        f"min ESS {float(ess.min()):.0f}  "
        f"adapted eps {float(chees.adapted_step_size):.3f}  "
        f"T {float(chees.adapted_trajectory_length):.2f}  "
        f"collection leapfrogs/step {chees._static_L}  "
        f"grads/draw {int(chees.leapfrog_count.sum()) / (N_CHAINS * 700):.2f}"
    )

    nuts = NUTS(
        tgt,
        init_with_seed(N_CHAINS, DIM, 0, device=device),
        target_accept_p=0.9,
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal"),
        max_tree_depth=4,
        backend="static",
        proposal="multinomial",
        seed=0,
        device=device,
    )
    nuts_sample = nuts.run(400, 300)
    nrhat, ness = split_rhat_mean_ess(nuts_sample)
    print(
        f"NUTS      : max R-hat {float(nrhat.max()):.4f}  "
        f"min ESS {float(ness.min()):.0f}  "
        f"grads/draw {int(nuts.leapfrog_count.sum()) / (N_CHAINS * 700):.2f}"
    )
    # Both sample the same posterior; ChEES typically spends 3-4x fewer
    # gradients per draw (no tree building, no rejected subtrees).
    return sample


if __name__ == "__main__":
    main()
