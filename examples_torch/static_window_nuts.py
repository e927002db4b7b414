"""The static-window NUTS backend on the port (examples/static_window_nuts.py)
on a small ill-conditioned Gaussian.  ``backend="static"`` runs all
``2^max_tree_depth − 1`` leapfrogs up front and evaluates the tree logic
retrospectively (``general_mcmc_torch/ops/static_tree.py``); it produces the
dynamic tree's exact transition law and wins whenever trees are
near-saturated at a small depth cap (caps ≤ 8; for deep caps use the
``"torch"`` tree, the JAX package's ``"xla"``, or let the default
``backend="auto"`` measure the warmup and decide, see auto_backend_nuts.py).
Supports identity, diagonal and dense mass matrices."""

import numpy as np

from general_mcmc_torch import NUTS, GaussianND, NUTSMassMatrixConfig, init_with_seed


def main(device=None):
    scales = np.exp(np.linspace(0.0, np.log(10.0), 16)).astype(np.float32)
    target = GaussianND(mean=np.zeros(16, np.float32), cov=scales)
    sampler = NUTS(
        target,
        init_with_seed(256, 16, 0, device=device),
        target_accept_p=0.9,
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal"),
        max_tree_depth=4,          # 15 leapfrogs per transition, always
        backend="static",
        seed=0,
        device=device,
    )
    sample, stats = sampler.run_progress(400, 200)
    print(f"Sample shape: {tuple(sample.shape)}")
    print(stats)
    # The counter reports the schedule's actual constant work.
    print(f"leapfrogs/transition: {int(sampler.leapfrog_count[0]) / 600:.0f}")
    assert tuple(sample.shape) == (256, 400, 16)
    return sample


if __name__ == "__main__":
    main()
