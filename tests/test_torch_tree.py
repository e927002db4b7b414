"""The port's mass-matrix ops, leapfrog and step-size search
(general_mcmc_torch/ops/tree.py) against the JAX package's
(general_mcmc_tpu/ops/tree.py, vmapped over chains), in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops import tree as jtree
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from general_mcmc_torch.ops import tree

RTOL = 1e-12  # float64, same arithmetic: rounding only


def _gauss(rng, d=5):
    mean, scales = rng.normal(size=d), np.exp(rng.normal(size=d) * 0.5)
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(scales))
    return jax.value_and_grad(jt.unnorm_logp), as_value_and_grad(
        to_target("GaussianND", mean, scales))


def _ball():
    """A standard normal cut off outside the ball of radius 3: a first
    leapfrog that leaves the ball is non-finite, so the search shrinks."""
    def jlogp(x):
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 9.0, -0.5 * r2, -jnp.inf)

    def plogp(x):
        r2 = torch.sum(x * x, dim=-1)
        return torch.where(r2 < 9.0, -0.5 * r2, -torch.inf)

    return jax.value_and_grad(jlogp), as_value_and_grad(plogp)


def _masses(rng, d, kind):
    """The identity or a random diagonal metric, in both packages."""
    if kind == "identity":
        return (jtree.identity_mass(d, False, jnp.float64),
                tree.identity_mass(d, torch.float64))
    inv = np.exp(rng.normal(size=d) * 0.5)
    scale = 1.0 / np.sqrt(inv)
    return (jtree.MassMatrix(jnp.asarray(inv), jnp.asarray(scale)),
            tree.MassMatrix(to_tensor(inv), to_tensor(scale)))


@pytest.mark.parametrize("kind", ["identity", "diag"])
def test_mass_ops_and_leapfrog_match_jax(kind):
    rng = np.random.default_rng(2)
    d, n = 5, 16
    jvg, pvg = _gauss(rng, d)
    jm, pm = _masses(rng, d, kind)
    x, z = rng.normal(size=(n, d)), rng.normal(size=(n, d))
    eps = rng.uniform(0.1, 0.6, size=n) * np.where(rng.uniform(size=n) < 0.5, -1, 1)

    j_mom = jax.vmap(lambda zz: jm.scale * zz)(jnp.asarray(z))
    p_mom = tree.sample_momentum(to_tensor(z), pm)
    np.testing.assert_allclose(p_mom.numpy(), np.asarray(j_mom), rtol=RTOL)
    np.testing.assert_allclose(
        tree.inv_mass_mul(pm, p_mom).numpy(),
        np.asarray(jax.vmap(lambda p: jtree.inv_mass_mul(jm, p, False))(j_mom)), rtol=RTOL)
    np.testing.assert_allclose(
        tree.kinetic_energy(pm, p_mom).numpy(),
        np.asarray(jax.vmap(lambda p: jtree.kinetic_energy(jm, p, False))(j_mom)), rtol=RTOL)

    _, g = jax.vmap(jvg)(jnp.asarray(x))
    want = jax.vmap(lambda xx, pp, gg, ee: jtree.leapfrog_chain(jvg, xx, pp, gg, ee, jm, False))(
        jnp.asarray(x), j_mom, g, jnp.asarray(eps))
    got = tree.leapfrog_chain(pvg, to_tensor(x), p_mom, to_tensor(np.asarray(g)),
                              to_tensor(eps), pm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("target", ["gauss", "ball"])
def test_find_reasonable_epsilon_matches_vmapped_jax(target):
    """16 chains of a 5-d target, each chain's ε equal to its own JAX loop's;
    on the ball the first leapfrog leaves it for some chains (phase 1)."""
    rng = np.random.default_rng(7)
    d, n = 5, 16
    jvg, pvg = _gauss(rng, d) if target == "gauss" else _ball()
    x = rng.normal(size=(n, d)) * (1.0 if target == "gauss" else 0.8)
    mom = rng.normal(size=(n, d)) * (1.0 if target == "gauss" else 2.5)
    jm = jtree.identity_mass(d, False, jnp.float64)
    want = np.asarray(jax.vmap(lambda xx, pp: jtree.find_reasonable_epsilon(
        jvg, xx, pp, jm, False))(jnp.asarray(x), jnp.asarray(mom)))
    got = tree.find_reasonable_epsilon(pvg, to_tensor(x), to_tensor(mom),
                                       tree.identity_mass(d, torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert len(np.unique(want)) > 1  # the chains' loops ended at different ε
    if target == "ball":
        assert (want < 0.5).any()  # phase 1 halved some chains' ε


def test_find_reasonable_epsilon_golden():
    """Standard normal at [0, 1] with momentum [1, 0]: exactly ε = 2.0
    (nuts.rs:508-519), batched beside a second chain."""
    vg = as_value_and_grad(to_target("GaussianND", np.zeros(2), np.ones(2)))
    x = torch.tensor([[0.0, 1.0], [0.0, 1.0]], dtype=torch.float64)
    p = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    eps = tree.find_reasonable_epsilon(vg, x, p, tree.identity_mass(2, torch.float64))
    assert eps.tolist() == [2.0, 2.0]


def test_find_reasonable_epsilon_raises_where_the_search_cannot_end():
    """A start with a non-finite log density: the JAX loop never ends; the
    port raises once ε has underflowed to 0."""
    def logp(x):
        return torch.full(x.shape[:1], -torch.inf, dtype=x.dtype) + 0.0 * x.sum(-1)

    x = torch.zeros(3, 2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="non-finite"):
        tree.find_reasonable_epsilon(as_value_and_grad(logp), x, torch.ones_like(x),
                                     tree.identity_mass(2, torch.float64))
