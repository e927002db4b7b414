"""The port's ``parallel`` package (general_mcmc_torch/parallel/) on four
gloo ranks on the CPU: every sampler's ``run_sharded`` against its
unsharded ``run``, ChEES's cross-chain reductions against JAX's
``ChEESHMC._step`` with JAX's draws injected, ``pooled_rhat_sharded``
against JAX's on its 8-device mesh, the (chains, dim) mesh, checkpoints
after a sharded run, and the paths that raise.

One module-scoped fixture spawns the four ranks once
(``tests/torch_parallel_ranks.py``); they run every scenario and write
their outputs, and the tests assert on them.  JAX runs only here, in the
parent; the ranks import ``general_mcmc_torch`` alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as jgmt
import torch_parallel_ranks as tpr
from general_mcmc_tpu.parallel import chain_mesh as jax_chain_mesh
from general_mcmc_tpu.parallel import pooled_rhat_sharded as jax_pooled_rhat
from general_mcmc_tpu.rng import step_key
from general_mcmc_torch import HMC, MetropolisHastings, RandomWalkProposal
from general_mcmc_torch.parallel import chain_mesh, make_mesh, run_sharded
from general_mcmc_torch.utils.checkpoint import load_carry

WORLD = 4
N_CHAINS = 16
# ChEES and the dim mesh in float64: the sharded sums run in another order
# (a sum of four partial sums), so the chains agree to rounding that the
# decisions of these short runs do not amplify (JAX's own dim and ChEES
# sharding tests hold 1e-8).
ATOL = 1e-8
# pooled R-hat in float64: sums of 4 per-rank partials against JAX's 8
RHAT_RTOL = 1e-12
J_STEPS, J_DISCARD = 12, 8


@jax.jit
def _jax_draws(keys, m):
    """ChEESHMC._propose's draws of step ``m``: fold_in(step key, 0) momenta,
    1 the accept uniform (tests/test_torch_chees.py)."""
    k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
    z = jax.vmap(lambda kk: jax.random.normal(jax.random.fold_in(kk, 0), (5,),
                                              jnp.float64))(k)
    u = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 1), (),
                                               jnp.float64))(k)
    return z, u


def _jax_chees_steps(rng):
    """JAX's ChEES on a 5-d Gaussian, 16 chains: the initial carry and 12
    steps of ``_step`` (8 of them warmup) with the draws each used."""
    mean, cov = rng.normal(size=5), np.exp(rng.normal(size=5) * 0.5)
    x0 = rng.normal(size=(N_CHAINS, 5)) * 1.5
    js = jgmt.ChEESHMC(jgmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
                       jnp.asarray(x0), seed=6, trajectory_length=2.0)
    z_eps = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 1), (5,),
                                                 jnp.float64))(js._chain_keys)
    step = jax.jit(lambda c, m: js._step(c, m, J_DISCARD))
    carry = js._init_carry()
    zs, us, states = [], [], []
    for m in range(J_STEPS):
        z, u = _jax_draws(js._chain_keys, jnp.asarray(m))
        zs.append(np.asarray(z))
        us.append(np.asarray(u))
        carry = step(carry, jnp.asarray(m))
        states.append(np.asarray(carry["pos"]))
    inputs = dict(j_mean=mean, j_cov=cov, j_x0=x0, j_z_eps=np.asarray(z_eps),
                  j_z=np.stack(zs), j_u=np.stack(us), j_n_discard=np.array(J_DISCARD))
    return inputs, np.stack(states), jax.device_get(carry)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs, the inputs and the JAX references."""
    rng = np.random.default_rng(0)
    inputs = dict(x0=rng.normal(size=(N_CHAINS, 2)), x4=rng.normal(size=(N_CHAINS, 4)),
                  x8=rng.normal(size=(8, 8)), x12=rng.normal(size=(8, tpr.ODD_DIM)))
    j_inputs, j_states, j_carry = _jax_chees_steps(rng)
    inputs.update(j_inputs)
    draws = rng.normal(size=(N_CHAINS, 40, 3))
    inputs.update(r_mean=draws.mean(axis=1), r_sm2=draws.var(axis=1, ddof=1),
                  r_steps=np.array(40))
    rhat = np.asarray(jax_pooled_rhat(jnp.asarray(inputs["r_mean"]),
                                      jnp.asarray(inputs["r_sm2"]), 40, jax_chain_mesh(8)))
    out_dir = tmp_path_factory.mktemp("ranks")
    outs = tpr.spawn("parallel", WORLD, inputs, out_dir)
    return dict(outs=outs, inputs=inputs, j_states=j_states, j_carry=j_carry, rhat=rhat,
                dir=out_dir)


def _rows(rank: int, n: int = N_CHAINS, world: int = WORLD) -> slice:
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def _gather(ranks, key) -> np.ndarray:
    return np.concatenate([o[key] for o in ranks["outs"]])


# -- chains axis: sharded equals unsharded -------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", tpr.EQUAL_CASES)
def test_sharded_equals_unsharded_bit_for_bit(ranks, name, dtype):
    """HMC, MH, MALA, replica exchange, Gibbs and NUTS have no cross-chain
    reduction: each rank's rows are the unsharded run's, bit for bit.
    ``"auto"`` under ``run_sharded`` is the ``"torch"`` run."""
    x0 = torch.from_numpy(ranks["inputs"]["x0"]).to(tpr.DTYPES[dtype])
    ref_name = "nuts_torch" if name == "nuts_auto" else name
    ref = tpr.make_sampler(ref_name, x0).run(*tpr.EQUAL_STEPS).numpy()
    for r, o in enumerate(ranks["outs"]):
        got = o[f"eq_{name}_{dtype}"]
        assert got.dtype == ref.dtype and got.shape == (4,) + ref.shape[1:]
        np.testing.assert_array_equal(got, ref[_rows(r)], err_msg=f"rank {r}")
    assert not np.array_equal(ranks["outs"][0][f"eq_{name}_{dtype}"],
                              ranks["outs"][1][f"eq_{name}_{dtype}"])


def test_auto_resolves_to_torch_without_measuring(ranks):
    assert {str(o["auto_selected"]) for o in ranks["outs"]} == {"torch"}


def test_chees_sharded_matches_unsharded(ranks):
    """ChEES's warmup reduces across chains every step: through the chains
    group the sharded run matches the unsharded one within 1e-8, with equal
    divergences and the same adapted ε̄ on every rank."""
    x0 = torch.from_numpy(ranks["inputs"]["x0"])
    ref = tpr.make_sampler("chees", x0)
    want = ref.run(*tpr.CHEES_STEPS).numpy()
    np.testing.assert_allclose(_gather(ranks, "chees"), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_gather(ranks, "chees_div"), ref.divergences.numpy())
    eps = {float(o["chees_eps_bar"]) for o in ranks["outs"]}
    assert len(eps) == 1
    np.testing.assert_allclose(eps.pop(), float(ref.adapted_step_size), rtol=1e-12)


def test_chees_static_collection_split_matches_unsharded(ranks):
    """tests/test_sharding.py's bench path: a whole initial carry sharded by
    the sampler's axes, the warmup through ``_step_fn``, then
    ``_run_static`` with ``L`` read from the sharded carry."""
    ref = tpr.static_chees(torch.from_numpy(ranks["inputs"]["x4"]))
    want = ref.run(*tpr.CHEES_STEPS).numpy()
    np.testing.assert_allclose(_gather(ranks, "static_split"), want, rtol=0, atol=ATOL)
    assert {int(o["static_L"]) for o in ranks["outs"]} == {ref._static_L}


def test_chees_sharded_step_matches_jax_step(ranks):
    """The port's sharded ``_step``, each rank fed its rows of JAX's draws,
    against JAX's unsharded ``_step`` over 12 steps (8 of warmup): every
    position, and the shared adaptation state on every rank."""
    want, jc = ranks["j_states"], ranks["j_carry"]
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_allclose(o["jax_states"], want[:, _rows(r)], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        for k in ("eps", "eps_bar", "h_bar", "mu", "log_t", "adam_m", "adam_v"):
            np.testing.assert_allclose(o[f"jax_steps_{k}"], np.asarray(jc[k]), rtol=1e-9,
                                       atol=1e-12, err_msg=k)
        np.testing.assert_allclose(o["jax_steps_mass_inv"], np.asarray(jc["mass_inv"])[0],
                                   rtol=1e-9)
        np.testing.assert_array_equal(o["jax_steps_n_leapfrog"],
                                      np.asarray(jc["n_leapfrog"])[_rows(r)])


def test_pooled_rhat_matches_jax(ranks):
    """Every rank's pooled R-hat from its rows equals JAX's
    ``pooled_rhat_sharded`` on its 8-device mesh."""
    for o in ranks["outs"]:
        np.testing.assert_allclose(o["rhat"], ranks["rhat"], rtol=RHAT_RTOL)
    assert all(np.array_equal(o["rhat"], ranks["outs"][0]["rhat"]) for o in ranks["outs"])


# -- the (chains, dim) mesh --------------------------------------------------------------
@pytest.mark.parametrize("name", list(tpr.DIM_STEPS))
def test_dim_sharded_2x2_matches_unsharded(ranks, name):
    """NUTS (the dynamic tree: the slice proposal, the multinomial one, and
    the diagonal warmup) and ChEES on a 2 x 2 mesh, 8 chains of the 8-d
    diagonal Gaussian in float64: each rank's [rows, columns] block of the
    unsharded run."""
    ref = tpr.make_dim_sampler(name, torch.from_numpy(ranks["inputs"]["x8"]))
    want = ref.run(*tpr.DIM_STEPS[name]).numpy()
    assert np.isfinite(want).all()
    for r, o in enumerate(ranks["outs"]):
        r0, r1, c0, c1 = (int(v) for v in o["dim_block"])
        assert (r1 - r0, c1 - c0) == (4, 4)
        np.testing.assert_allclose(o[f"dim_{name}"], want[r0:r1, :, c0:c1], rtol=0,
                                   atol=ATOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"dim_{name}_div"], ref.divergences[r0:r1].numpy())


@pytest.mark.parametrize("name", list(tpr.ODD_STEPS))
def test_dim_sharded_odd_split_matches_unsharded(ranks, name):
    """NUTS (dynamic tree, diagonal metric) and ChEES on a 1 x 4 mesh over
    12 coordinates: blocks of 3 from columns 0, 3, 6 and 9, two of them at
    an odd coordinate, whose momentum normals are filled from the even word
    before.  Each rank's block equals the unsharded run within 1e-8 in
    float64."""
    ref = tpr.make_odd_sampler(name, torch.from_numpy(ranks["inputs"]["x12"]))
    want = ref.run(*tpr.ODD_STEPS[name]).numpy()
    assert np.isfinite(want).all()
    starts = []
    for r, o in enumerate(ranks["outs"]):
        r0, r1, c0, c1 = (int(v) for v in o["odd_block"])
        assert (r0, r1, c1 - c0) == (0, 8, 3)
        starts.append(c0)
        np.testing.assert_allclose(o[f"odd_{name}"], want[:, :, c0:c1], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"odd_{name}_div"], ref.divergences.numpy())
    assert starts == [0, 3, 6, 9]


@pytest.mark.parametrize("name", tpr.FUSED_CASES)
def test_fused_backend_sharded_equals_unsharded(ranks, name):
    """``run_sharded`` of HMC and MH with ``backend="cuda"``: each rank runs
    its block through the fused run with its ``chain0`` (the plain version
    on the CPU), and its rows are the unsharded run's, bit for bit."""
    x0 = torch.from_numpy(ranks["inputs"]["x0"]).float()
    want = tpr.make_fused_sampler(name, x0).run(*tpr.EQUAL_STEPS).numpy()
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_array_equal(o[f"fused_{name}"], want[_rows(r)], err_msg=f"rank {r}")


# -- checkpoints after a sharded run ---------------------------------------------------------
@pytest.mark.parametrize("name", ["hmc", "chees_static"])
def test_checkpoint_after_run_sharded(ranks, name):
    """``save_checkpoint`` writes each rank's block with its step count and
    first chain; ``resume`` on the bound sampler continues it as the
    uninterrupted unsharded run."""
    inp = ranks["inputs"]
    make = ((lambda: tpr.make_sampler("hmc", torch.from_numpy(inp["x0"])))
            if name == "hmc" else (lambda: tpr.static_chees(torch.from_numpy(inp["x4"]))))
    want = make().run(11, 4).numpy()[:, 6:]
    # HMC has no cross-chain reduction; ChEES's sharded warmup sums in
    # another order, so its adapted ε̄ and T agree to rounding
    atol = 0.0 if name == "hmc" else ATOL
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_allclose(o[f"resume_{name}"], want[_rows(r)], rtol=0, atol=atol)
        state = load_carry(str(ranks["dir"] / f"ckpt_{name}_{r}.npz"), device="cpu")
        assert (int(state["steps"]), int(state["n_chains"])) == (10, 4)
        assert (int(state["chain0"]), int(state["col0"])) == (4 * r, 0)


def test_checkpoint_of_another_block_raises(ranks):
    fresh = tpr.make_sampler("hmc", torch.from_numpy(ranks["inputs"]["x0"][:4]))
    with pytest.raises(ValueError, match="block from chain 4"):
        fresh.resume(str(ranks["dir"] / "ckpt_hmc_1.npz"), 2)


# -- one rank, no process group ------------------------------------------------------------------
@pytest.mark.parametrize("name", ["hmc", "nuts_torch", "chees"])
def test_one_rank_mesh_equals_run(name):
    """Without a process group ``chain_mesh()`` is one rank, and
    ``run_sharded`` on it is ``run`` bit for bit."""
    x0 = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 2)))
    want = tpr.make_sampler(name, x0).run(6, 6)
    mesh = chain_mesh()
    assert mesh.size == 1 and mesh.chains_group is None
    got = run_sharded(tpr.make_sampler(name, x0), 6, 6, mesh)
    assert torch.equal(got, want)


def _unsupported():
    """The dim axis's one refusal: a fused kernel (``backend="cuda"``) holds
    whole rows, so HMC's and MH's under ``shard_dim`` raise, naming
    ``backend='torch'``."""
    x8 = torch.zeros(4, 8)
    cases = {
        "hmc_cuda": lambda: HMC(tpr.dim_target().to(dtype=torch.float32), x8, 0.1, 3,
                                backend="cuda", device="cpu"),
        "mh_cuda": lambda: MetropolisHastings(tpr.dim_target().to(dtype=torch.float32),
                                              RandomWalkProposal(0.5), x8, backend="cuda",
                                              device="cpu"),
    }
    return cases


@pytest.mark.parametrize("case", list(_unsupported()))
def test_unsupported_dim_paths_raise(case):
    make = _unsupported()[case]
    with pytest.raises(NotImplementedError, match="backend='torch'"):
        run_sharded(make(), 2, 2, make_mesh(1, 1), shard_dim=True)


def test_fused_backend_raises_on_a_block():
    """The fused kernels address a block's rows by their global chain
    (``chain0``), so a block raises only what the unsharded run raises: a
    target the kernel does not take.  On one a kernel takes, the block runs
    and is ``run``'s result."""
    x0 = torch.zeros(4, 2)
    for runner in (lambda s: run_sharded(s, 2, 2, chain_mesh()), lambda s: s.run(2, 2)):
        with pytest.raises(ValueError, match="fused HMC kernels take the targets"):
            runner(HMC(lambda x: -0.5 * (x * x).sum(-1), x0, 0.1, 3, backend="cuda",
                       device="cpu"))
    x0 = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 2))).float()
    for name in tpr.FUSED_CASES:
        got = run_sharded(tpr.make_fused_sampler(name, x0), 6, 6, chain_mesh())
        assert torch.equal(got, tpr.make_fused_sampler(name, x0).run(6, 6))
