"""Rank programs for the tests of the port's ``parallel`` package, and the
harness that runs one of them on gloo ranks on the CPU.

Imported by ``tests/test_torch_parallel.py`` and
``tests/test_torch_distributed.py`` (not collected: no ``test_`` prefix) and
run as a worker, one process a rank::

    python -m torch_parallel_ranks <program> <port> <rank> <world> <dir>

A worker reads ``<dir>/inputs.npz``, joins a gloo group through
``parallel.initialize`` at ``tcp://127.0.0.1:<port>``, runs its program and
writes ``<dir>/rank<r>.npz``.  It imports ``general_mcmc_torch`` and no
JAX: reference values computed with JAX arrive as numpy in the inputs.  The
sampler factories below are shared with the tests, which run the unsharded
references in their own process.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.convert import to_target
from general_mcmc_torch.core import run_kernel
from general_mcmc_torch.parallel import (chain_mesh, global_chain_mesh, init_positions_on_mesh,
                                         initialize, make_mesh, pooled_rhat_sharded,
                                         run_sharded, shard_carry)
from general_mcmc_torch.parallel.runner import shard_sampler

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent

DTYPES = {"f32": torch.float32, "f64": torch.float64}


# -- samplers shared with the tests ----------------------------------------------
def gauss2(dtype):
    return gmt.DiffableGaussian2D([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]], dtype=dtype,
                                  device="cpu")


def chain_graph(draws, i, x):
    """x_0 ~ N(0, 1), x_i ~ N(0.5·x_{i−1}, 1): a Gibbs conditional."""
    z = draws.normal(0)
    return z if i == 0 else 0.5 * x[:, i - 1] + z


def make_sampler(name: str, x0: torch.Tensor):
    """One of the equality cases on the 2-d Gaussian, built on ``x0``."""
    t = gauss2(x0.dtype)
    kw = dict(seed=4, device="cpu")
    if name == "hmc":
        return gmt.HMC(t, x0, 0.1, 5, **kw)
    if name == "mh":
        return gmt.MetropolisHastings(t, gmt.RandomWalkProposal(1.0), x0, **kw)
    if name == "mala":
        return gmt.MALA(t, x0, 0.5, **kw)
    if name == "tempering":
        ladder = gmt.geometric_temperatures(4, 8.0, device="cpu")
        return gmt.ReplicaExchange(t, x0, ladder, scale=0.8, **kw)
    if name == "gibbs":
        return gmt.GibbsSampler(chain_graph, x0, **kw)
    if name.startswith("nuts_"):
        return gmt.NUTS(t, x0, 0.8, max_tree_depth=4, backend=name[5:], **kw)
    if name == "chees":
        return gmt.ChEESHMC(t, x0, **kw)
    raise ValueError(name)


EQUAL_CASES = ("hmc", "mh", "mala", "tempering", "gibbs", "nuts_torch", "nuts_static",
               "nuts_auto")
EQUAL_STEPS = (10, 10)  # collected, discarded
CHEES_STEPS = (12, 12)


def static_chees(inits):
    target = gmt.GaussianND(torch.zeros(4, dtype=torch.float64),
                            torch.linspace(1.0, 2.0, 4, dtype=torch.float64), device="cpu")
    return gmt.ChEESHMC(target, inits, seed=5, static_collection=True, static_leapfrog=4,
                        device="cpu")


def dim_target():
    return gmt.GaussianND(torch.zeros(8, dtype=torch.float64),
                          torch.linspace(1.0, 3.0, 8, dtype=torch.float64), device="cpu")


def make_dim_sampler(name: str, inits):
    """The 2 x 2 dim cases of ``tests/test_sharding.py`` on the port, the
    adapting NUTS's trees at depth 5 at most: every leapfrog of a
    dim-sharded tree is an all-reduce across the ranks, and the deeper trees
    of its early warmup had been most of the rank programs' time."""
    t = dim_target()
    if name == "nuts":
        return gmt.NUTS(t, inits, 0.8, seed=11, backend="torch", device="cpu")
    if name == "nuts_multinomial":
        return gmt.NUTS(t, inits, 0.8, seed=11, backend="torch", max_tree_depth=6,
                        proposal="multinomial", device="cpu")
    if name == "nuts_adapt":
        cfg = gmt.NUTSMassMatrixConfig(adaptation="diagonal", start_buffer=5, end_buffer=5,
                                       initial_window=10)
        return gmt.NUTS(t, inits, 0.8, seed=11, backend="torch", mass_config=cfg,
                        max_tree_depth=5, device="cpu")
    if name == "chees":
        return gmt.ChEESHMC(t, inits, seed=11, device="cpu")
    raise ValueError(name)


DIM_STEPS = {"nuts": (6, 6), "nuts_multinomial": (6, 6), "nuts_adapt": (5, 30),
             "chees": (8, 8)}

# The odd split: 12 coordinates over a dim axis of 4, blocks of 3 from
# columns 0, 3, 6 and 9.
ODD_DIM = 12
ODD_STEPS = {"nuts_adapt": (5, 30), "chees": (8, 8)}


def odd_target():
    return gmt.GaussianND(torch.zeros(ODD_DIM, dtype=torch.float64),
                          torch.linspace(1.0, 3.0, ODD_DIM, dtype=torch.float64),
                          device="cpu")


def make_odd_sampler(name: str, inits):
    """NUTS (dynamic tree, diagonal metric, depth 5 at most as
    make_dim_sampler's) and ChEES on the 12-d target."""
    if name == "nuts_adapt":
        cfg = gmt.NUTSMassMatrixConfig(adaptation="diagonal", start_buffer=5, end_buffer=5,
                                       initial_window=10)
        return gmt.NUTS(odd_target(), inits, 0.8, seed=13, backend="torch", mass_config=cfg,
                        max_tree_depth=5, device="cpu")
    if name == "chees":
        return gmt.ChEESHMC(odd_target(), inits, seed=13, device="cpu")
    raise ValueError(name)


def make_fused_sampler(name: str, x0: torch.Tensor):
    """HMC and MH with ``backend="cuda"`` on targets their fused kernels
    take (on the CPU their plain versions run)."""
    kw = dict(seed=4, backend="cuda", device="cpu")
    if name == "hmc_cuda":
        t = gmt.GaussianND(torch.tensor([0.0, 1.0]), torch.tensor([1.5, 0.7]), device="cpu")
        return gmt.HMC(t, x0, 0.3, 5, mass_inv=torch.tensor([1.2, 0.8]), **kw)
    if name == "mh_cuda":
        t = gmt.Gaussian2D(torch.tensor([0.0, 1.0]), torch.tensor([[4.0, 2.0], [2.0, 3.0]]),
                           device="cpu")
        return gmt.MetropolisHastings(t, gmt.RandomWalkProposal(1.0), x0, **kw)
    raise ValueError(name)


FUSED_CASES = ("hmc_cuda", "mh_cuda")


# -- rank programs ---------------------------------------------------------------
def program_parallel(rank: int, world: int, inp: dict, out_dir: Path) -> dict:
    """Every scenario of tests/test_torch_parallel.py on this rank."""
    out = {}
    mesh = chain_mesh()
    lo, hi = mesh.rows(16)
    for tag, dtype in DTYPES.items():
        x0 = torch.from_numpy(inp["x0"]).to(dtype)
        for name in EQUAL_CASES:
            s = make_sampler(name, x0)
            out[f"eq_{name}_{tag}"] = run_sharded(s, *EQUAL_STEPS, mesh).numpy()
            if name == "nuts_auto":
                out["auto_selected"] = np.array(s.backend_selected)
    x64 = torch.from_numpy(inp["x0"])
    c = make_sampler("chees", x64)
    out["chees"] = run_sharded(c, *CHEES_STEPS, mesh).numpy()
    out["chees_div"] = c.divergences.numpy()
    out["chees_eps_bar"] = c.adapted_step_size.numpy()

    # the static-collection split of tests/test_sharding.py: a whole initial
    # carry sharded, the warmup through _step_fn, then _run_static
    s = static_chees(torch.from_numpy(inp["x4"]))
    s._prepare_run(*CHEES_STEPS)
    whole = s._init_carry()
    shard_sampler(s, mesh)
    carry = shard_carry(whole, mesh, s._carry_axes(whole))
    warm = run_kernel(s._step_fn, carry, 0, CHEES_STEPS[1]).carry
    out["static_split"] = s._run_static(warm, CHEES_STEPS[0], CHEES_STEPS[1]).transpose(
        0, 1).numpy()
    out["static_L"] = np.array(s._static_L)

    # ChEES's sharded _step with JAX's draws injected
    j = inp
    ps = gmt.ChEESHMC(to_target("GaussianND", j["j_mean"], j["j_cov"]),
                      torch.from_numpy(j["j_x0"]), seed=6, trajectory_length=2.0,
                      device="cpu")
    shard_sampler(ps, mesh)
    pc = ps._init_carry(z_eps=torch.from_numpy(j["j_z_eps"][lo:hi]))
    states = []
    for m in range(j["j_z"].shape[0]):
        pc = ps._step(pc, m, int(j["j_n_discard"]), z=torch.from_numpy(j["j_z"][m, lo:hi]),
                      u=torch.from_numpy(j["j_u"][m, lo:hi]))
        states.append(pc["pos"].numpy())
    out["jax_states"] = np.stack(states)
    for k, v in pc.items():
        out[f"jax_steps_{k}"] = v.numpy()

    out["rhat"] = pooled_rhat_sharded(torch.from_numpy(inp["r_mean"][lo:hi]),
                                      torch.from_numpy(inp["r_sm2"][lo:hi]),
                                      int(inp["r_steps"]), mesh).numpy()

    # save_checkpoint after run_sharded, then resume on the bound sampler
    for name in ("hmc", "chees_static"):
        s = (make_sampler("hmc", x64) if name == "hmc"
             else static_chees(torch.from_numpy(inp["x4"])))
        run_sharded(s, 6, 4, mesh)
        path = str(out_dir / f"ckpt_{name}_{rank}.npz")
        s.save_checkpoint(path)
        out[f"resume_{name}"] = s.resume(path, 5).numpy()

    # the 2 x 2 (chains, dim) mesh
    mesh2 = make_mesh(2, 2)
    inits = torch.from_numpy(inp["x8"])
    for name, steps in DIM_STEPS.items():
        s = make_dim_sampler(name, inits)
        out[f"dim_{name}"] = run_sharded(s, *steps, mesh2, shard_dim=True).numpy()
        out[f"dim_{name}_div"] = s.divergences.numpy()
    out["dim_block"] = np.array(mesh2.rows(8) + mesh2.cols(8))

    # the odd split: a 1 x 4 mesh, blocks of 3 coordinates
    mesh4 = make_mesh(1, 4)
    for name, steps in ODD_STEPS.items():
        s = make_odd_sampler(name, torch.from_numpy(inp["x12"]))
        out[f"odd_{name}"] = run_sharded(s, *steps, mesh4, shard_dim=True).numpy()
        out[f"odd_{name}_div"] = s.divergences.numpy()
    out["odd_block"] = np.array(mesh4.rows(8) + mesh4.cols(ODD_DIM))

    # HMC's and MH's fused backends on a block of chains
    for name in FUSED_CASES:
        out[f"fused_{name}"] = run_sharded(
            make_fused_sampler(name, torch.from_numpy(inp["x0"]).float()), *EQUAL_STEPS,
            mesh).numpy()
    return out


def program_distributed(rank: int, world: int, inp: dict, out_dir: Path) -> dict:
    """Every scenario of tests/test_torch_distributed.py on this rank."""
    out = {"again": np.array(initialize()),
           "world": np.array(torch.distributed.get_world_size())}
    mesh = global_chain_mesh()
    out["mesh_ranks"] = np.array(mesh.ranks)
    meshes = {"4": mesh, "2": make_mesh(2, 2), "1": make_mesh(1, 4)}
    for k, m in meshes.items():
        out[f"init_{k}"] = init_positions_on_mesh(16, 5, 3, m, device="cpu").numpy()
        out[f"rows_{k}"] = np.array(m.rows(16))
    try:
        init_positions_on_mesh(10, 3, 1, mesh, device="cpu")
        out["indivisible"] = np.array("no error")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))

    # a sampler built on the whole array and one built on the rank's block
    target = gmt.GaussianND(torch.zeros(3), torch.ones(3), device="cpu")
    whole = init_positions_on_mesh(16, 3, 5, meshes["1"], device="cpu")
    block = init_positions_on_mesh(16, 3, 5, mesh, device="cpu")
    for name, make in (
            ("mh", lambda x: gmt.MetropolisHastings(target, gmt.RandomWalkProposal(0.8), x,
                                                    seed=7, device="cpu")),
            ("chees", lambda x: gmt.ChEESHMC(target, x, seed=11, device="cpu"))):
        out[f"whole_{name}"] = run_sharded(make(whole), 8, 8, mesh).numpy()
        out[f"block_{name}"] = run_sharded(make(block), 8, 8, mesh, local_rows=True).numpy()
    return out


# examples_torch/sharded_nuts.py at tests/test_examples.py's cut sizes
EXAMPLE_SHARDED_ARGS = dict(n_chains=64, dim=8, n_collect=30, n_warmup=80)


def program_example_sharded(rank: int, world: int, inp: dict, out_dir: Path) -> dict:
    """The port's sharded example, loaded by path, on this rank."""
    import importlib.util

    path = _REPO / "examples_torch" / "sharded_nuts.py"
    spec = importlib.util.spec_from_file_location("examples_torch_sharded_nuts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"sample": mod.main(**EXAMPLE_SHARDED_ARGS, device="cpu").numpy()}


def program_dim_axis(rank: int, world: int, inp: dict, out_dir: Path) -> dict:
    """Every scenario of tests/test_torch_dim_axis.py on this rank
    (``tests/torch_dim_axis_ranks.py``)."""
    import torch_dim_axis_ranks

    return torch_dim_axis_ranks.program(rank, world, inp, out_dir)


PROGRAMS = {"parallel": program_parallel, "distributed": program_distributed,
            "example_sharded": program_example_sharded, "dim_axis": program_dim_axis}


# -- harness ---------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(program: str, world: int, inputs: dict, out_dir: Path,
          timeout: float = 600.0) -> list[dict]:
    """Run ``program`` on ``world`` gloo ranks, one process each; returns
    each rank's outputs.  A rank that fails or times out fails the call,
    with its output in the message; every process is ended."""
    out_dir = Path(out_dir)
    np.savez(out_dir / "inputs.npz", **inputs)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": os.pathsep.join([str(_REPO), str(_TESTS),
                                          os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-m", "torch_parallel_ranks", program,
                               str(port), str(r), str(world), str(out_dir)],
                              env=env, cwd=_TESTS, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {program} exited {p.returncode}:\n{log[-4000:]}")
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def main(argv) -> int:
    program, port, rank, world, out_dir = argv
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    torch.set_num_threads(1)
    try:
        initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                   backend="gloo", timeout=datetime.timedelta(seconds=120))
        inp = dict(np.load(out_dir / "inputs.npz"))
        out = PROGRAMS[program](rank, world, inp, out_dir)
        np.savez(out_dir / f"rank{rank}.npz", **out)
        torch.distributed.destroy_process_group()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
