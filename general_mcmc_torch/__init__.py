"""general_mcmc_torch: the PyTorch and CUDA (Hopper) port of general_mcmc_tpu.

Batched HMC and Metropolis–Hastings, each with a fused whole-run CUDA kernel
(``backend="cuda"``) and a plain PyTorch backend; ChEES-HMC, NUTS (the
dynamic tree, the static window and ``backend="auto"``, slice and
multinomial proposals, Stan-windowed diagonal and dense metrics), MALA,
Gibbs sampling and replica exchange in plain PyTorch, the draws of every
eager step from the counter generator's fill kernel on the card; the
Gaussian, Rosenbrock, funnel, discrete and hierarchical-logistic targets,
the fused logistic gradient chain (``ops.fused_logistic``); the sampler
runtime (``chain``, ``track``, checkpoints and ``resume``, ``run_progress``
with streaming R-hat) on every sampler; split-R-hat/ESS, streaming and
rank-normalized diagnostics; and sample export (``io``: CSV through the
repo's native writer, Arrow and Parquet through pyarrow).  Entry points run
on the card unless given ``device="cpu"``.
The package imports torch and numpy only; its CUDA sources are compiled
with ``nvcc`` at first use.
"""

from .core import (
    advance_kernel,
    init,
    init_det,
    init_with_seed,
    run_kernel,
    run_kernel_progress,
    run_kernel_progress_stream,
    run_kernel_stats,
)
from .diagnostics.stats import (
    BasicStats,
    ChainStats,
    ChainTracker,
    MultiChainTracker,
    RunStats,
    basic_stats,
    chain_suffstats,
    collect_rhat,
    combine_suffstats_host,
    ess_bulk,
    ess_from_chainstats,
    ess_tail,
    max_skipnan,
    rank_normalized_rhat,
    rank_normalized_summary,
    split_rhat_mean_ess,
)
from .models.distributions import (
    Binomial,
    Categorical,
    DiffableGaussian2D,
    Gaussian2D,
    GaussianND,
    IsotropicGaussian,
    NealsFunnel,
    Poisson,
    Rosenbrock2D,
    RosenbrockND,
)
from .models.regression import (
    HierarchicalLogistic,
    HierarchicalLogisticNC,
    make_logistic_data,
)
from .samplers.base import BatchChain, BatchSampler
from .samplers.chees import ChEESHMC, halton_base2
from .samplers.gibbs import GibbsSampler
from .samplers.hmc import HMC, leapfrog
from .samplers.mala import MALA
from .samplers.metropolis_hastings import (
    DiscreteWalkProposal,
    MetropolisHastings,
    PCNProposal,
    RandomWalkProposal,
)
from .samplers.nuts import NUTS, NUTSMassMatrixConfig
from .samplers.tempering import ReplicaExchange, geometric_temperatures

__all__ = [
    "NUTS",
    "NUTSMassMatrixConfig",
    "ChEESHMC",
    "halton_base2",
    "HMC",
    "leapfrog",
    "MALA",
    "GibbsSampler",
    "ReplicaExchange",
    "geometric_temperatures",
    "MetropolisHastings",
    "RandomWalkProposal",
    "PCNProposal",
    "DiscreteWalkProposal",
    "GaussianND",
    "DiffableGaussian2D",
    "Gaussian2D",
    "IsotropicGaussian",
    "Rosenbrock2D",
    "RosenbrockND",
    "NealsFunnel",
    "Poisson",
    "Binomial",
    "Categorical",
    "HierarchicalLogistic",
    "HierarchicalLogisticNC",
    "make_logistic_data",
    "init",
    "init_det",
    "init_with_seed",
    "run_kernel",
    "run_kernel_stats",
    "advance_kernel",
    "run_kernel_progress",
    "run_kernel_progress_stream",
    "BatchSampler",
    "BatchChain",
    "split_rhat_mean_ess",
    "chain_suffstats",
    "combine_suffstats_host",
    "BasicStats",
    "ChainStats",
    "ChainTracker",
    "MultiChainTracker",
    "RunStats",
    "basic_stats",
    "collect_rhat",
    "ess_bulk",
    "ess_from_chainstats",
    "ess_tail",
    "max_skipnan",
    "rank_normalized_rhat",
    "rank_normalized_summary",
]
