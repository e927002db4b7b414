"""Minimal NUTS example on the port (examples/minimal_nuts.py,
examples/minimal_nuts.rs): 4 chains on the 2-D Rosenbrock density with
dual-averaged step size, live progress, on the card unless
``device="cpu"``."""

from general_mcmc_torch import NUTS, Rosenbrock2D, init


def main(device=None):
    target = Rosenbrock2D(a=1.0, b=100.0)
    sampler = NUTS(target, init(4, 2, device=device), target_accept_p=0.95,
                   device=device).set_seed(42)
    sample, stats = sampler.run_progress(400, 400)
    print(f"Sample shape: {tuple(sample.shape)}")
    print(stats)
    assert tuple(sample.shape) == (4, 400, 2)
    return sample


if __name__ == "__main__":
    main()
