"""Minimal HMC example on the port (examples/minimal_hmc.py,
examples/minimal_hmc.rs): batched HMC on the 3-D Rosenbrock density, on the
card unless ``device="cpu"``."""

from general_mcmc_torch import HMC, RosenbrockND, init_det


def main(device=None):
    sampler = HMC(RosenbrockND(), init_det(4, 3, device=device), step_size=0.032,
                  n_leapfrog=10, device=device)
    sample = sampler.run(400, 50)
    print(f"Collected sample with shape: {tuple(sample.shape)}")
    assert tuple(sample.shape) == (4, 400, 3)
    return sample


if __name__ == "__main__":
    main()
