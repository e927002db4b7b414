"""Cases and the rank program of ``tests/test_torch_dim_axis.py``: every
sampler of the port on every target, with its parameter axis split over
the ranks (``run_sharded(..., shard_dim=True)``), and the hierarchical
logistic blocks' densities.

Imported by the test file (not collected: no ``test_`` prefix) and, through
``tests/torch_parallel_ranks.py``'s program ``"dim_axis"``, by each gloo
rank.  It imports ``general_mcmc_torch`` and no JAX: the JAX references
arrive as numpy in the inputs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.parallel import make_mesh, run_sharded
from general_mcmc_torch.parallel.runner import shard_sampler

F64 = torch.float64
N_CHAINS = 8
DIM = 12  # 2 x 2: blocks of 6; 1 x 4: blocks of 3 from columns 0, 3, 6, 9
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
N_OBS = 30  # the logistic cases' observations (DIM - 2 features)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _spd(d: int, seed: int) -> torch.Tensor:
    a = _rng(seed).normal(size=(d, d)) * 0.3
    return torch.from_numpy(a @ a.T + np.eye(d))


def logistic_data(n_obs: int, p: int, seed: int = 3):
    """``(X [n_obs, p], y [n_obs])`` float64 numpy, the logistic cases' data."""
    rng = _rng(seed)
    X = rng.normal(size=(n_obs, p))
    beta = rng.normal(size=p) * 0.5
    y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, y


def coupled_logp(x):
    """A user's batch callable whose terms couple neighbours (autograd)."""
    w = torch.linspace(0.5, 1.5, x.shape[-1], dtype=x.dtype)
    return -0.5 * (w * x * x).sum(-1) - 0.2 * (x[:, :-1] * x[:, 1:]).sum(-1)


def integer_logp(x):
    """A user's target over integer states: independent discretised
    Gaussians about 2."""
    d = x.to(F64) - 2.0
    return -0.3 * (d * d).sum(-1)


class ShiftProposal:
    """A user's asymmetric proposal with no column block: a drift towards 0
    that couples the coordinates through the row's mean."""

    symmetric = False
    draws = "normal"

    def propose(self, x, z):
        return 0.9 * x + 0.05 * x.mean(-1, keepdim=True) + 0.4 * z

    def logp(self, from_, to):
        diff = (to - 0.9 * from_ - 0.05 * from_.mean(-1, keepdim=True)) / 0.4
        return -0.5 * (diff * diff).sum(-1)


def chain_graph(draws, i, x):
    """x_0 ~ N(0, 1), x_i ~ N(0.5·x_{i−1}, 1): a Gibbs conditional."""
    z = draws.normal(0)
    return z if i == 0 else 0.5 * x[:, i - 1] + z


def targets():
    X, y = logistic_data(N_OBS, DIM - 2)
    return {
        "diag": gmt.GaussianND(torch.zeros(DIM, dtype=F64),
                               torch.linspace(1.0, 3.0, DIM, dtype=F64), device="cpu"),
        "dense": gmt.GaussianND(torch.linspace(-1.0, 1.0, DIM, dtype=F64), _spd(DIM, 7),
                                device="cpu"),
        "isotropic": gmt.IsotropicGaussian(1.3),
        "rosenbrock": gmt.RosenbrockND(),
        "funnel": gmt.NealsFunnel(dim=DIM, v_std=1.5),
        "logistic_nc": gmt.HierarchicalLogisticNC(torch.from_numpy(X), torch.from_numpy(y)),
        "logistic_centred": gmt.HierarchicalLogistic(torch.from_numpy(X),
                                                     torch.from_numpy(y)),
        "callable": coupled_logp,
    }


def initial_states(seed: int = 0) -> dict:
    """Each case family's ``[N_CHAINS, DIM]`` starts."""
    rng = _rng(seed)
    x = rng.normal(size=(N_CHAINS, DIM))
    rosen = 1.0 + 0.05 * rng.normal(size=(N_CHAINS, DIM))
    funnel = x.copy()
    funnel[:, -1] = 0.3 * funnel[:, -1]
    logistic = 0.3 * rng.normal(size=(N_CHAINS, DIM))
    ints = rng.integers(-1, 5, size=(N_CHAINS, DIM))
    return {"x": x, "rosen": rosen, "funnel": funnel, "logistic": logistic, "ints": ints}


_WINDOWS = dict(start_buffer=3, end_buffer=3, initial_window=6)


def make_case(name: str, starts: dict):
    """The sampler of case ``name`` on its starts (``initial_states``),
    float64 (integer states for the discrete walk)."""
    t = targets()
    kw = dict(seed=9, device="cpu")
    x = torch.from_numpy(starts["x"])
    lg = torch.from_numpy(starts["logistic"])
    nuts = dict(max_tree_depth=4, backend="torch", **kw)
    dense_cfg = gmt.NUTSMassMatrixConfig("dense", **_WINDOWS)
    cases = {
        "hmc": lambda: gmt.HMC(t["diag"], x, 0.3, 4,
                               mass_inv=torch.linspace(0.5, 1.5, DIM, dtype=F64), **kw),
        "hmc_dense_mass": lambda: gmt.HMC(t["diag"], x, 0.3, 4,
                                          mass_inv=_spd(DIM, 5) * 0.5, **kw),
        "hmc_dense": lambda: gmt.HMC(t["dense"], x, 0.2, 4, **kw),
        "hmc_logistic_nc": lambda: gmt.HMC(t["logistic_nc"], lg, 0.05, 4, **kw),
        "hmc_logistic_centred": lambda: gmt.HMC(t["logistic_centred"], lg, 0.03, 4, **kw),
        "hmc_callable": lambda: gmt.HMC(t["callable"], x, 0.3, 4, **kw),
        "mh_walk": lambda: gmt.MetropolisHastings(t["diag"], gmt.RandomWalkProposal(0.6), x,
                                                  **kw),
        "mh_pcn": lambda: gmt.MetropolisHastings(t["isotropic"], gmt.PCNProposal(0.4), x,
                                                 **kw),
        "mh_rosenbrock": lambda: gmt.MetropolisHastings(
            t["rosenbrock"], gmt.RandomWalkProposal(0.02), torch.from_numpy(starts["rosen"]),
            **kw),
        "mh_discrete": lambda: gmt.MetropolisHastings(
            integer_logp, gmt.DiscreteWalkProposal(1), torch.from_numpy(starts["ints"]), **kw),
        "mh_user_proposal": lambda: gmt.MetropolisHastings(t["dense"], ShiftProposal(), x,
                                                           **kw),
        "mh_isotropic_proposal": lambda: gmt.MetropolisHastings(
            t["callable"], gmt.IsotropicGaussian(0.5), x, **kw),
        "mala": lambda: gmt.MALA(t["diag"], x, 0.5, **kw),
        "mala_funnel": lambda: gmt.MALA(t["funnel"], torch.from_numpy(starts["funnel"]), 0.3,
                                        **kw),
        "tempering": lambda: gmt.ReplicaExchange(
            t["diag"], x, gmt.geometric_temperatures(4, 8.0, device="cpu"), scale=0.6, **kw),
        "gibbs": lambda: gmt.GibbsSampler(chain_graph, x, **kw),
        "nuts": lambda: gmt.NUTS(t["funnel"], torch.from_numpy(starts["funnel"]), 0.8, **nuts),
        "nuts_static": lambda: gmt.NUTS(t["diag"], x, 0.8, max_tree_depth=3,
                                        backend="static", seed=9, device="cpu"),
        "nuts_dense_metric": lambda: gmt.NUTS(t["diag"], x, 0.8, mass_config=dense_cfg,
                                              **nuts),
        "nuts_static_dense_metric": lambda: gmt.NUTS(
            t["dense"], x, 0.8, mass_config=dense_cfg, max_tree_depth=3, backend="static",
            seed=9, device="cpu"),
        "nuts_dense": lambda: gmt.NUTS(t["dense"], x, 0.8, **nuts),
        "nuts_logistic_centred": lambda: gmt.NUTS(t["logistic_centred"], lg, 0.8, **nuts),
        "chees": lambda: gmt.ChEESHMC(t["diag"], x, **kw),
        "chees_logistic_nc": lambda: gmt.ChEESHMC(t["logistic_nc"], lg, **kw),
        "chees_callable": lambda: gmt.ChEESHMC(t["callable"], x, **kw),
        "chees_isotropic": lambda: gmt.ChEESHMC(t["isotropic"], x, **kw),
    }
    return cases[name]()


CASES = ("hmc", "hmc_dense_mass", "hmc_dense", "hmc_logistic_nc", "hmc_logistic_centred",
         "hmc_callable", "mh_walk", "mh_pcn", "mh_rosenbrock", "mh_discrete",
         "mh_user_proposal", "mh_isotropic_proposal", "mala", "mala_funnel", "tempering",
         "gibbs", "nuts", "nuts_static", "nuts_dense_metric", "nuts_static_dense_metric",
         "nuts_dense", "nuts_logistic_centred", "chees", "chees_logistic_nc",
         "chees_callable", "chees_isotropic")
# (collected, discarded): the dense metric's warmup holds a window end
STEPS = {name: (6, 6) for name in CASES}
STEPS.update(nuts_dense_metric=(3, 14), nuts_static_dense_metric=(3, 14))


# save_checkpoint after a dim-sharded run, then resume on a fresh sampler
# bound to the same block: the diagonal GaussianND (a true column block)
# and a user's callable (a GatheredBlock), RESUME_STEPS more states
CHECKPOINT_CASES = ("mh_walk", "hmc_callable")
RESUME_STEPS = 5


def counts(sampler) -> dict:
    """The discrete outcomes a run keeps besides its states: NUTS's and
    ChEES's divergence and leapfrog counts."""
    out = {}
    for k in ("divergences", "leapfrog_count"):
        v = getattr(sampler, k, None)
        if v is not None:
            out[k] = v.numpy()
    return out


# The logistic blocks against JAX: p = 2 on the 1 x 4 mesh (μ, log τ, z₁, z₂
# each on a rank of its own) and the stretch line's p = 48 on the 2 x 2 mesh
# (blocks of 25, μ and log τ both in the first).
LOGISTIC_SHAPES = {"p2": (2, "1x4", 20), "p48": (48, "2x2", 256)}
LOGISTIC_ROWS = 8
# θ's scales: 0.3 against JAX (the logits stay below 20, where F.softplus,
# the port's form, is the exact softplus), 1.0 against the port's own
# unsharded target (logits to ~150, past F.softplus's threshold)
LOGISTIC_SCALES = (0.3, 1.0)

# ChEES's dim-sharded _step on HierarchicalLogisticNC with JAX's draws
# injected: 16 chains, 6 features, the 2 x 2 mesh
CJ_CHAINS, CJ_P, CJ_OBS, CJ_STEPS, CJ_DISCARD = 16, 6, 24, 10, 6


def logistic_target(kind: str, X, y):
    cls = gmt.HierarchicalLogisticNC if kind == "nc" else gmt.HierarchicalLogistic
    return cls(torch.from_numpy(X), torch.from_numpy(y))


def program(rank: int, world: int, inp: dict, out_dir: Path) -> dict:
    """Every case on both meshes, the logistic blocks' densities and
    ChEES's injected-draw steps, on this rank."""
    out = {}
    starts = {k[len("start_"):]: v for k, v in inp.items() if k.startswith("start_")}
    meshes = {k: make_mesh(*m) for k, m in MESHES.items()}
    for mesh_name, mesh in meshes.items():
        out[f"block_{mesh_name}"] = np.array(mesh.rows(N_CHAINS) + mesh.cols(DIM))
        for name in CASES:
            s = make_case(name, starts)
            out[f"{mesh_name}_{name}"] = run_sharded(s, *STEPS[name], mesh,
                                                     shard_dim=True).numpy()
            for k, v in counts(s).items():
                out[f"{mesh_name}_{name}_{k}"] = v
        for name in CHECKPOINT_CASES:
            s = make_case(name, starts)
            run_sharded(s, *STEPS[name], mesh, shard_dim=True)
            path = str(out_dir / f"ckpt_{mesh_name}_{name}_{rank}.npz")
            s.save_checkpoint(path)
            fresh = shard_sampler(make_case(name, starts), mesh, shard_dim=True)
            out[f"{mesh_name}_{name}_resume"] = fresh.resume(path, RESUME_STEPS).numpy()

    for shape, (p, mesh_name, n_obs) in LOGISTIC_SHAPES.items():
        mesh = meshes[mesh_name]
        r0, r1 = mesh.rows(LOGISTIC_ROWS)
        c0, c1 = mesh.cols(p + 2)
        for scale in LOGISTIC_SCALES:
            theta = scale * torch.from_numpy(inp[f"lg_{shape}_theta"][r0:r1, c0:c1])
            for kind in ("nc", "centred"):
                block = logistic_target(kind, inp[f"lg_{shape}_X"],
                                        inp[f"lg_{shape}_y"]).columns(c0, c1, mesh.dim_group,
                                                                      p + 2)
                key = f"lg_{shape}_{scale}_{kind}"
                out[f"{key}_logp"] = block.unnorm_logp(theta).numpy()
                out[f"{key}_grad"] = block.unnorm_logp_grad(theta).numpy()
                lp, g = block.value_and_grad(theta)
                out[f"{key}_vg_logp"], out[f"{key}_vg_grad"] = lp.numpy(), g.numpy()
        out[f"lg_{shape}_block"] = np.array((r0, r1, c0, c1))

    mesh = meshes["2x2"]
    r0, r1 = mesh.rows(CJ_CHAINS)
    c0, c1 = mesh.cols(CJ_P + 2)
    s = gmt.ChEESHMC(logistic_target("nc", inp["cj_X"], inp["cj_y"]),
                     torch.from_numpy(inp["cj_x0"]), seed=6, trajectory_length=2.0,
                     device="cpu")
    shard_sampler(s, mesh, shard_dim=True)
    carry = s._init_carry(z_eps=torch.from_numpy(inp["cj_z_eps"][r0:r1, c0:c1]))
    states = []
    for m in range(CJ_STEPS):
        carry = s._step(carry, m, CJ_DISCARD, z=torch.from_numpy(inp["cj_z"][m, r0:r1, c0:c1]),
                        u=torch.from_numpy(inp["cj_u"][m, r0:r1]))
        states.append(carry["pos"].numpy())
    out["cj_states"] = np.stack(states)
    for k, v in carry.items():
        out[f"cj_{k}"] = v.numpy()
    out["cj_block"] = np.array((r0, r1, c0, c1))
    return out
