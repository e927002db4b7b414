"""general_mcmc_torch: the PyTorch and CUDA (Hopper) port of general_mcmc_tpu.

Batched HMC with a fused whole-run CUDA kernel (``HMC(..., backend="cuda")``),
its plain PyTorch backend, the Gaussian targets, and split-R-hat/ESS
diagnostics.  Entry points run on the card unless given ``device="cpu"``.
The package imports torch and numpy only; its CUDA sources are compiled
with ``nvcc`` at first use.
"""

from .core import init, init_det, init_with_seed, run_kernel, run_kernel_stats
from .diagnostics.stats import (
    chain_suffstats,
    combine_suffstats_host,
    split_rhat_mean_ess,
)
from .models.distributions import DiffableGaussian2D, GaussianND
from .samplers.hmc import HMC, leapfrog

__all__ = [
    "HMC",
    "leapfrog",
    "GaussianND",
    "DiffableGaussian2D",
    "init",
    "init_det",
    "init_with_seed",
    "run_kernel",
    "run_kernel_stats",
    "split_rhat_mean_ess",
    "chain_suffstats",
    "combine_suffstats_host",
]
