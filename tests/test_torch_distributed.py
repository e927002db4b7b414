"""The port's multi-process recipe (general_mcmc_torch/parallel/distributed.py):
``initialize`` outside and inside a process group, ``global_chain_mesh``,
``init_positions_on_mesh`` over 1, 2 and 4 chain shards, and a sampler
built on the whole array against one built on the rank's block.

One module-scoped fixture spawns four gloo ranks on the CPU once
(``tests/torch_parallel_ranks.py``); the tests assert on their outputs."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as tpr
from general_mcmc_torch.ops import counter_rng
from general_mcmc_torch.parallel import (chain_mesh, global_chain_mesh,
                                         init_positions_on_mesh, initialize)
from general_mcmc_torch.parallel.distributed import _CLUSTER_ENV_VARS
from general_mcmc_torch.rng import stream_key

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tpr.spawn("distributed", WORLD, {}, tmp_path_factory.mktemp("ranks"))


def test_initialize_is_a_noop_outside_a_cluster(monkeypatch):
    for v in _CLUSTER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert initialize() is False
    assert not dist.is_initialized()
    mesh = global_chain_mesh()
    assert mesh.size == 1 and mesh.ranks == [[0]] and mesh.chains_group is None


def test_initialize_nccl_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: NCCL is allowed")
    with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
        initialize(init_method="tcp://127.0.0.1:1", world_size=1, rank=0, backend="nccl")
    assert not dist.is_initialized()


def test_initialize_is_idempotent_inside_a_group(ranks):
    assert all(bool(o["again"]) and int(o["world"]) == WORLD for o in ranks)


def test_global_chain_mesh_covers_the_world(ranks):
    for o in ranks:
        np.testing.assert_array_equal(o["mesh_ranks"], np.arange(WORLD)[:, None])


def test_init_positions_layout_invariant(ranks):
    """The same global array from 1, 2 and 4 chain shards (and from no
    process group): row i is chain i's TAG_INIT pairs, whichever rank draws
    it."""
    want = counter_rng.counter_rng_fill(16, 5, stream_key(3), 0, counter_rng.TAG_INIT,
                                        "normal_pair", "cpu").numpy()
    alone = init_positions_on_mesh(16, 5, 3, chain_mesh(), device="cpu").numpy()
    np.testing.assert_array_equal(alone, want)
    for k in ("4", "2", "1"):
        glued = np.zeros_like(want)
        for o in ranks:
            lo, hi = (int(v) for v in o[f"rows_{k}"])
            assert o[f"init_{k}"].shape == (hi - lo, 5) and o[f"init_{k}"].dtype == np.float32
            glued[lo:hi] = o[f"init_{k}"]
        np.testing.assert_array_equal(glued, want, err_msg=f"{k} chain shards")
    scaled = init_positions_on_mesh(16, 5, 3, chain_mesh(), scale=2.5, device="cpu").numpy()
    np.testing.assert_array_equal(scaled, want * np.float32(2.5))


def test_init_positions_indivisible_count_raises(ranks):
    assert all("divisible" in str(o["indivisible"]) for o in ranks)


@pytest.mark.parametrize("name", ["mh", "chees"])
def test_whole_array_and_rank_block_give_the_same_rows(ranks, name):
    """A sampler built on the whole array (sliced by ``run_sharded``) and
    one built on the rank's block (``local_rows=True``) run the same
    chains, bit for bit, ChEES's cross-chain warmup included."""
    for o in ranks:
        np.testing.assert_array_equal(o[f"whole_{name}"], o[f"block_{name}"])
        assert o[f"whole_{name}"].shape == (4, 8, 3)
    assert not np.array_equal(ranks[0][f"whole_{name}"], ranks[1][f"whole_{name}"])
