"""Multi-process NUTS on the port: chains sharded over ranks
(examples/sharded_nuts.py).

Each rank of a ``torch.distributed`` job holds a block of the chains and
runs it with no communication while sampling; the pooled R-hat reduces
per-chain moments with one ``all_reduce`` over the chains axis.  Run one
process per card under ``torchrun`` (NCCL):

    torchrun --nproc-per-node=1 examples_torch/sharded_nuts.py

Outside a job (no ``torchrun`` variables) ``initialize`` does nothing and
the mesh is this one process.  Every rank returns the whole sample,
gathered from the blocks.
"""

import math

import torch

from general_mcmc_torch import NUTS, GaussianND, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.parallel import chain_mesh, initialize, pooled_rhat_sharded, run_sharded
from general_mcmc_torch.parallel.collectives import gather_rows


def main(n_chains=512, dim=16, n_collect=200, n_warmup=200, seed=0, device=None):
    initialize()
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())  # this rank's card
    mesh = chain_mesh()
    n_ranks = mesh.size
    n_chains -= n_chains % n_ranks  # chains must tile the mesh
    print(f"mesh: {n_ranks} rank(s), {n_chains} chains")

    scales = torch.exp(torch.linspace(0.0, math.log(5.0), dim))
    target = GaussianND(mean=torch.zeros(dim), cov=scales)
    sampler = NUTS(
        target,
        init_with_seed(n_chains, dim, seed, device=device),
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal", start_buffer=50,
                                         end_buffer=25, initial_window=25),
        seed=seed,
        device=device,
    )
    block = run_sharded(sampler, n_collect, n_warmup, mesh)
    lo, hi = mesh.rows(n_chains)
    print(f"rank block: chains [{lo}, {hi}) of {n_chains}, {tuple(block.shape)}")

    # Cross-rank pooled R-hat from per-chain sufficient statistics.
    mean = block.mean(dim=1)
    sm2 = block.var(dim=1, correction=1)
    rhat = pooled_rhat_sharded(mean, sm2, n_collect, mesh)
    print(f"pooled R-hat (all_reduce over the mesh): max={float(rhat.max()):.4f}")
    sample = gather_rows(block, mesh.chains_group, lo, n_chains)
    assert bool(torch.isfinite(sample).all())
    return sample


if __name__ == "__main__":
    main()
