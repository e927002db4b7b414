"""Stan's multinomial proposal vs the classic slice sampler (NUTS), on the
port (examples/multinomial_nuts.py).

``proposal="multinomial"`` weights every trajectory leaf by
``exp(joint − joint₀)`` instead of thresholding against a slice variable,
so proposals land on low-density leaves less often — same trajectories,
same U-turn rule and adaptation.  Works on both tree backends and with
diagonal or dense mass.
"""

import numpy as np

from general_mcmc_torch import NUTS, GaussianND, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.diagnostics.stats import split_rhat_mean_ess


def run(proposal: str, device=None):
    scales = np.exp(np.linspace(0.0, np.log(10.0), 16)).astype(np.float32)
    target = GaussianND(mean=np.zeros(16, np.float32), cov=scales)
    sampler = NUTS(
        target,
        init_with_seed(256, 16, 0, device=device),
        target_accept_p=0.9,
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal"),
        max_tree_depth=4,
        backend="static",
        proposal=proposal,
        seed=0,
        device=device,
    )
    sample = sampler.run(400, 200)
    rhat, ess = split_rhat_mean_ess(sample)
    return sample, float(rhat.max()), float(ess.min())


def main(device=None):
    results = {}
    for proposal in ("slice", "multinomial"):
        sample, rhat_max, min_ess = run(proposal, device)
        results[proposal] = (rhat_max, min_ess)
        print(f"{proposal:12s}: max R-hat {rhat_max:.4f}  min ESS {min_ess:.0f}")
        assert tuple(sample.shape) == (256, 400, 16)
        assert rhat_max < 1.05
    # Both laws target the same posterior; the multinomial run is usually
    # the more ESS-efficient one (a statistical tendency, not a per-seed
    # guarantee — no assert on the ordering).
    return results


if __name__ == "__main__":
    main()
