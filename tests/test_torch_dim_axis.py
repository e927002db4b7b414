"""The port's dim axis (``run_sharded(..., shard_dim=True)``) for every
sampler on every target, on four gloo ranks on the CPU.

- Every sampler (HMC with a diagonal and a dense ``mass_inv``, MH with the
  walk, pCN, the discrete walk, a user's proposal and the isotropic one,
  MALA, replica exchange, Gibbs, NUTS's dynamic and static trees with the
  dense metric, ChEES) on the diagonal and the dense ``GaussianND``,
  ``IsotropicGaussian``, ``RosenbrockND``, ``NealsFunnel``, both
  hierarchical logistic targets and a user's callable, on a 2 x 2 mesh
  (blocks of 6 columns) and a 1 x 4 mesh (blocks of 3 from columns 0, 3, 6
  and 9): each rank's ``[rows, columns]`` block within 1e-8 of the
  unsharded run in float64, its discrete outcomes (which steps moved the
  block, the integer states, divergence and leapfrog counts) exact.
- The logistic targets' column blocks against JAX's ``unnorm_logp``,
  ``unnorm_logp_grad`` and ``jax.grad`` at 1e-12 relative, and against
  the port's own unsharded targets at θ twice as wide.
- ChEES's dim-sharded ``_step`` on ``HierarchicalLogisticNC`` against
  JAX's ``ChEESHMC._step`` with JAX's draws injected.
- Every block draw against the unsharded draw's columns, bit for bit.
- A dim-sharded run's ``save_checkpoint`` resumed on a fresh sampler bound
  to the same block against the unsharded run's resume, bit for bit.

One module-scoped fixture spawns the four ranks once
(``tests/torch_parallel_ranks.py``, program ``"dim_axis"`` of
``tests/torch_dim_axis_ranks.py``); the unsharded runs are made here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as jgmt
import torch_dim_axis_ranks as tdr
import torch_parallel_ranks as tpr
from general_mcmc_tpu.models.regression import HierarchicalLogistic as JaxLogistic
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_tpu.rng import step_key
from general_mcmc_torch.ops import counter_rng
from torch_threads import one_thread  # noqa: F401

WORLD = 4
# float64; the sharded sums add the column blocks' partial sums in another
# order than the whole row's sum, so the chains agree to rounding that these
# short runs' decisions do not amplify (JAX's own dim tests hold 1e-8)
ATOL = 1e-8
# the logistic blocks' densities against JAX's in float64: the logits from
# μ·(X 1)ᵀ + τ·(z Xᵀ) and the sums over four blocks, against X β
LOGISTIC_RTOL = 1e-12


def _jax_chees_logistic(rng):
    """JAX's ChEES on ``HierarchicalLogisticNC``: the initial carry's ε
    search normals and ``CJ_STEPS`` steps of ``_step`` with the draws each
    used (fold_in(step key, 0) the momenta, 1 the accept uniform)."""
    X, y = tdr.logistic_data(tdr.CJ_OBS, tdr.CJ_P, seed=11)
    d = tdr.CJ_P + 2
    x0 = 0.3 * rng.normal(size=(tdr.CJ_CHAINS, d))
    js = jgmt.ChEESHMC(JaxLogisticNC(X=jnp.asarray(X), y=jnp.asarray(y)),
                       jnp.asarray(x0), seed=6, trajectory_length=2.0)

    @jax.jit
    def draws(keys, m):
        k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
        z = jax.vmap(lambda kk: jax.random.normal(jax.random.fold_in(kk, 0), (d,),
                                                  jnp.float64))(k)
        u = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 1), (),
                                                   jnp.float64))(k)
        return z, u

    z_eps = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 1), (d,),
                                                 jnp.float64))(js._chain_keys)
    step = jax.jit(lambda c, m: js._step(c, m, tdr.CJ_DISCARD))
    carry = js._init_carry()
    zs, us, states = [], [], []
    for m in range(tdr.CJ_STEPS):
        z, u = draws(js._chain_keys, jnp.asarray(m))
        zs.append(np.asarray(z))
        us.append(np.asarray(u))
        carry = step(carry, jnp.asarray(m))
        states.append(np.asarray(carry["pos"]))
    inputs = dict(cj_X=X, cj_y=y, cj_x0=x0, cj_z_eps=np.asarray(z_eps), cj_z=np.stack(zs),
                  cj_u=np.stack(us))
    return inputs, np.stack(states), jax.device_get(carry)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs, the inputs and the JAX ChEES references."""
    rng = np.random.default_rng(0)
    inputs = {f"start_{k}": v for k, v in tdr.initial_states().items()}
    for shape, (p, _, n_obs) in tdr.LOGISTIC_SHAPES.items():
        X, y = tdr.logistic_data(n_obs, p, seed=len(shape))
        inputs.update({f"lg_{shape}_X": X, f"lg_{shape}_y": y,
                       f"lg_{shape}_theta": rng.normal(size=(tdr.LOGISTIC_ROWS, p + 2))})
    cj_inputs, cj_states, cj_carry = _jax_chees_logistic(rng)
    inputs.update(cj_inputs)
    outs = tpr.spawn("dim_axis", WORLD, inputs, tmp_path_factory.mktemp("dim_axis"))
    return dict(outs=outs, inputs=inputs, cj_states=cj_states, cj_carry=cj_carry)


@pytest.fixture(scope="module")
def unsharded(ranks):
    """Each case's unsharded run (``[n, steps, d]``) and its counts."""
    starts = {k[len("start_"):]: v for k, v in ranks["inputs"].items()
              if k.startswith("start_")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name in tdr.CASES:
        s = tdr.make_case(name, starts)
        out[name] = (s.run(*tdr.STEPS[name]).numpy(), tdr.counts(s))
    torch.set_num_threads(threads)
    return out


def _blocks(ranks, mesh):
    for r, o in enumerate(ranks["outs"]):
        r0, r1, c0, c1 = (int(v) for v in o[f"block_{mesh}"])
        yield r, o, slice(r0, r1), slice(c0, c1)


def _moved(x: np.ndarray) -> np.ndarray:
    """``[n, steps − 1]``: whether each step changed any of ``x``'s
    columns."""
    return (x[:, 1:] != x[:, :-1]).any(axis=-1)


@pytest.mark.parametrize("mesh", list(tdr.MESHES))
@pytest.mark.parametrize("name", tdr.CHECKPOINT_CASES)
def test_dim_sharded_checkpoint_resumes_as_unsharded(ranks, name, mesh, tmp_path):
    """``run_sharded(..., shard_dim=True)``, ``save_checkpoint`` on every
    rank, then ``resume`` on a fresh sampler bound to the same block: each
    rank's ``[rows, columns]`` block is the unsharded run's resume's, bit for
    bit (a column-block target and a gathered one; their positions depend
    on the sharded sums only through the accept decisions)."""
    starts = {k[len("start_"):]: v for k, v in ranks["inputs"].items()
              if k.startswith("start_")}
    s = tdr.make_case(name, starts)
    s.run(*tdr.STEPS[name])
    path = str(tmp_path / "unsharded.npz")
    s.save_checkpoint(path)
    want = tdr.make_case(name, starts).resume(path, tdr.RESUME_STEPS).numpy()
    assert want.shape == (tdr.N_CHAINS, tdr.RESUME_STEPS, tdr.DIM)
    assert (want[:, 1:] != want[:, :-1]).any()
    for r, o, rows, cols in _blocks(ranks, mesh):
        got = o[f"{mesh}_{name}_resume"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want[rows, :, cols], err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh", list(tdr.MESHES))
@pytest.mark.parametrize("name", tdr.CASES)
def test_block_equals_unsharded(ranks, unsharded, name, mesh):
    """Each rank's ``[rows, columns]`` block of the dim-sharded run is the
    unsharded run's block within 1e-8 in float64."""
    want = unsharded[name][0]
    assert np.isfinite(want.astype(np.float64)).all()
    starts = []
    for r, o, rows, cols in _blocks(ranks, mesh):
        got = o[f"{mesh}_{name}"]
        assert got.shape == want[rows, :, cols].shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want[rows, :, cols], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        starts.append(cols.start)
    assert starts == ([0, 6, 0, 6] if mesh == "2x2" else [0, 3, 6, 9])


@pytest.mark.parametrize("mesh", list(tdr.MESHES))
@pytest.mark.parametrize("name", tdr.CASES)
def test_block_discrete_outcomes_exact(ranks, unsharded, name, mesh):
    """Which steps moved each block, the integer states of the discrete
    walk, and NUTS's and ChEES's divergence and leapfrog counts are the
    unsharded run's exactly, and the rows' counts the same on every rank
    of a dim group."""
    want, want_counts = unsharded[name]
    for r, o, rows, cols in _blocks(ranks, mesh):
        got = o[f"{mesh}_{name}"]
        np.testing.assert_array_equal(_moved(got), _moved(want[rows, :, cols]),
                                      err_msg=f"rank {r}")
        if not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want[rows, :, cols])
        for k, v in want_counts.items():
            np.testing.assert_array_equal(o[f"{mesh}_{name}_{k}"], v[rows], err_msg=k)


def _jax_logistic(kind: str, X, y):
    cls = JaxLogisticNC if kind == "nc" else JaxLogistic
    return cls(X=jnp.asarray(X), y=jnp.asarray(y))


def _logistic_blocks(ranks, shape, kind, scale, lp, grads):
    """Each rank's logistic block outputs at ``scale`` against the whole
    log density ``lp`` and the gradients ``grads`` at 1e-12 relative;
    returns the ranks holding μ and log τ."""
    key = f"lg_{shape}_{scale}_{kind}"
    holders = {0: [], 1: []}
    for r, o in enumerate(ranks["outs"]):
        r0, r1, c0, c1 = (int(v) for v in o[f"lg_{shape}_block"])
        for k in (0, 1):
            if c0 <= k < c1:
                holders[k].append(r)
        for sfx in ("", "_vg"):
            np.testing.assert_allclose(o[f"{key}{sfx}_logp"], lp[r0:r1], rtol=LOGISTIC_RTOL,
                                       err_msg=f"rank {r}{sfx}")
            for which, g in grads.items():
                np.testing.assert_allclose(o[f"{key}{sfx}_grad"], g[r0:r1, c0:c1],
                                           rtol=LOGISTIC_RTOL, err_msg=f"rank {r} {which}")
    return holders


@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("shape", list(tdr.LOGISTIC_SHAPES))
def test_logistic_blocks_match_jax(ranks, shape, kind):
    """The column blocks of both hierarchical logistic targets (p = 2 on
    the 1 x 4 mesh, one coordinate a rank; p = 48 on the 2 x 2 mesh, μ and
    log τ in the first block): the log density on every rank, and the
    block's gradient from ``unnorm_logp_grad`` and from ``value_and_grad``,
    against JAX's ``unnorm_logp``, ``unnorm_logp_grad`` and
    ``jax.grad(unnorm_logp)`` at 1e-12 relative, at θ ~ N(0, 0.3²): there
    every logit stays below 20, where ``F.softplus`` (the port's form, which
    its kernels share; linear past 20) is the exact softplus of JAX's
    targets.  ``test_logistic_blocks_match_unsharded`` takes wider θ."""
    inp = ranks["inputs"]
    X = inp[f"lg_{shape}_X"]
    target = _jax_logistic(kind, X, inp[f"lg_{shape}_y"])
    theta = 0.3 * inp[f"lg_{shape}_theta"]
    beta = theta[:, 2:]
    if kind == "nc":
        beta = theta[:, :1] + np.exp(theta[:, 1:2]) * beta
    assert np.abs(beta @ X.T).max() < 20.0
    lp = np.asarray(jax.vmap(target.unnorm_logp)(jnp.asarray(theta)))
    grads = {"analytic": np.asarray(jax.vmap(target.unnorm_logp_grad)(jnp.asarray(theta))),
             "autodiff": np.asarray(jax.vmap(jax.grad(target.unnorm_logp))(
                 jnp.asarray(theta)))}
    holders = _logistic_blocks(ranks, shape, kind, 0.3, lp, grads)
    if shape == "p2":  # μ and log τ each on a rank of its own
        assert holders == {0: [0], 1: [1]}


@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("shape", list(tdr.LOGISTIC_SHAPES))
def test_logistic_blocks_match_unsharded(ranks, shape, kind):
    """The same blocks at θ ~ N(0, 1), logits to ~150, against the port's
    own unsharded target at 1e-12 relative."""
    inp = ranks["inputs"]
    target = tdr.logistic_target(kind, inp[f"lg_{shape}_X"], inp[f"lg_{shape}_y"])
    theta = torch.from_numpy(inp[f"lg_{shape}_theta"])
    lp = target.unnorm_logp(theta).numpy()
    _logistic_blocks(ranks, shape, kind, 1.0,
                     lp, {"analytic": target.unnorm_logp_grad(theta).numpy()})


def test_chees_logistic_step_matches_jax(ranks):
    """ChEES's ``_step`` on ``HierarchicalLogisticNC`` on the 2 x 2 mesh,
    each rank fed its block of JAX's draws, against JAX's unsharded
    ``_step`` over 10 steps (6 of warmup): every block of the positions, and
    the shared adaptation state on every rank."""
    want, jc = ranks["cj_states"], ranks["cj_carry"]
    for r, o in enumerate(ranks["outs"]):
        r0, r1, c0, c1 = (int(v) for v in o["cj_block"])
        np.testing.assert_allclose(o["cj_states"], want[:, r0:r1, c0:c1], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        for k in ("eps", "eps_bar", "h_bar", "mu", "log_t", "adam_m", "adam_v"):
            np.testing.assert_allclose(o[f"cj_{k}"], np.asarray(jc[k]), rtol=1e-9,
                                       atol=1e-12, err_msg=k)
        np.testing.assert_allclose(o["cj_mass_inv"], np.asarray(jc["mass_inv"])[0, c0:c1],
                                   rtol=1e-9)
        np.testing.assert_array_equal(o["cj_n_leapfrog"], np.asarray(jc["n_leapfrog"])[r0:r1])


# -- block draws: the unsharded draws' columns, bit for bit --------------------------
D_TOTAL = 11
SEED, STEP, CHAIN0, N = 12345, 7, 5, 6


def _whole_and_block(kind: str, lo: int, hi: int):
    """``(unsharded draws' columns lo … hi − 1, the block's draws)`` of
    ``kind``, each a tuple of tensors."""
    k, cr = counter_rng, dict(device="cpu", chain0=CHAIN0)
    d = hi - lo
    if kind == "step":
        return (tuple(v[:, lo:hi] if v.ndim == 2 else v
                      for v in k.step_draws(SEED, N, STEP, D_TOTAL, **cr)),
                k.step_draws(SEED, N, STEP, d, word0=lo, **cr))
    if kind in ("walk", "mala"):
        tag = k.TAG_PROPOSAL if kind == "walk" else k.TAG_MALA
        z, u = k.walk_draws(SEED, N, STEP, D_TOTAL, tag, **cr)
        return (z[:, lo:hi], u), k.walk_draws(SEED, N, STEP, d, tag, word0=lo,
                                              d_total=D_TOTAL, **cr)
    if kind == "sign":
        up, u = k.sign_walk_draws(SEED, N, STEP, D_TOTAL, **cr)
        return (up[:, lo:hi], u), k.sign_walk_draws(SEED, N, STEP, d, word0=lo,
                                                    d_total=D_TOTAL, **cr)
    if kind == "tempering":
        z, ua, us = k.tempering_draws(SEED, N, STEP, 4, D_TOTAL, **cr)
        return (z[:, :, lo:hi], ua, us), k.tempering_draws(SEED, N, STEP, 4, d, word0=lo,
                                                           d_total=D_TOTAL, **cr)
    if kind == "eps_search":  # NUTS's and ChEES's initial step-size search
        fill = lambda width, w0: k.counter_rng_fill(N, width, SEED, 0, k.TAG_EPS_SEARCH,
                                                    "normal_pair", "cpu", CHAIN0, w0)
        return (fill(D_TOTAL, 0)[:, lo:hi],), (fill(d, lo),)
    if kind == "nuts":
        z, u = k.nuts_draws(SEED, N, STEP, D_TOTAL, 3, **cr)
        return (z[:, lo:hi], u), k.nuts_draws(SEED, N, STEP, d, 3, word0=lo, **cr)
    if kind == "static":
        z, w = k.static_draws(SEED, N, STEP, D_TOTAL, 3, **cr)
        return (z[:, lo:hi], w), k.static_draws(SEED, N, STEP, d, 3, word0=lo, **cr)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["step", "walk", "mala", "sign", "tempering",
                                  "eps_search", "nuts", "static"])
def test_block_draws_bit_equal(kind):
    """Every block of columns ``lo … hi − 1`` of an 11-coordinate row, at
    even and odd starts and widths, draws the unsharded draws' columns and
    the row's own per-chain draws, bit for bit, on the plain version."""
    for lo in range(D_TOTAL):
        for hi in range(lo + 1, D_TOTAL + 1):
            want, got = _whole_and_block(kind, lo, hi)
            assert len(want) == len(got)
            for a, b in zip(want, got):
                assert a.dtype == b.dtype and a.shape == b.shape, (lo, hi)
                assert torch.equal(a, b), (kind, lo, hi)
