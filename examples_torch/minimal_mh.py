"""Minimal Metropolis–Hastings example on the port (examples/minimal_mh.py,
examples/minimal_mh.rs).

4 parallel chains sampling a standard 2D Gaussian with an isotropic
random-walk proposal, on the card unless ``device="cpu"``.
"""

from general_mcmc_torch import Gaussian2D, IsotropicGaussian, MetropolisHastings, init_det


def main(device=None):
    target = Gaussian2D(mean=[0.0, 0.0], cov=[[1.0, 0.0], [0.0, 1.0]])
    proposal = IsotropicGaussian(1.0)

    mh = MetropolisHastings(target, proposal, init_det(4, 2, device=device), device=device)
    sample = mh.run(1000, 100)

    assert tuple(sample.shape) == (4, 1000, 2)
    print(f"Collected sample with shape {tuple(sample.shape)}")
    return sample


if __name__ == "__main__":
    main()
