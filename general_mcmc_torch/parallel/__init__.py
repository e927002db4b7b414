"""Chains (and coordinates) split over ranks on ``torch.distributed``: the
port of ``general_mcmc_tpu/parallel/``, one process per card."""

from .collectives import pooled_rhat_sharded
from .distributed import global_chain_mesh, init_positions_on_mesh, initialize
from .mesh import CHAINS_AXIS, DIM_AXIS, chain_mesh, make_mesh, shard_carry
from .runner import run_sharded

__all__ = [
    "pooled_rhat_sharded",
    "global_chain_mesh",
    "init_positions_on_mesh",
    "initialize",
    "CHAINS_AXIS",
    "DIM_AXIS",
    "chain_mesh",
    "make_mesh",
    "shard_carry",
    "run_sharded",
]
