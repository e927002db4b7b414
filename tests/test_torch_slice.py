"""The port's slices end to end on the CPU through the public names: the
benchmark target's arrays carried over from the JAX package, HMC and MH
through their fused-run entry points (the plain versions, since the tensors
lie on the CPU), the logistic gradient chain, and the diagnostics, held
against the targets and against the JAX diagnostics on the same sample.
Also: the package stands alone (no JAX), and entry points refuse to run on
a missing card."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.diagnostics.stats import split_rhat_mean_ess as jax_split_rhat
from general_mcmc_torch import HMC, init_with_seed, split_rhat_mean_ess
from general_mcmc_torch.convert import to_target, to_tensor
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pooled moments of a 128 x 300 sample: ESS in the thousands, so the
# sampling error of a mean is ~0.02 scale units; the tolerances allow 5x
MEAN_ATOL, STD_RTOL = 0.1, 0.06
# float32 samples: two FFT libraries and orders of summation
DIAG_RTOL = 2e-4


def test_slice_small_on_cpu():
    d, n = 8, 128
    scales = np.exp(np.linspace(0.0, np.log(10.0), d)).astype(np.float32)
    jt = gmt.GaussianND(mean=jnp.zeros(d, jnp.float32), cov=jnp.asarray(scales))
    target = to_target("GaussianND", np.asarray(jt.mean), np.asarray(jt.cov))
    x0 = to_tensor(np.asarray(gmt.init_det(n, d)))
    mass_inv = to_tensor(scales**2)
    samples = HMC(target, x0, 0.4, 10, seed=0, mass_inv=mass_inv, backend="cuda",
                  device="cpu").run(300, 100)
    assert tuple(samples.shape) == (n, 300, d) and samples.dtype == torch.float32
    store = samples.transpose(0, 1)
    rhat, ess, mean, std = split_rhat_mean_ess(store, steps_major=True, return_moments=True)
    assert float(rhat.max()) < 1.01
    assert float(ess.min()) > 1000
    np.testing.assert_allclose(mean.numpy() / scales, 0.0, atol=MEAN_ATOL)
    np.testing.assert_allclose(std.numpy(), scales, rtol=STD_RTOL)
    # the port's diagnostics on the port's sample are the JAX diagnostics
    want = jax_split_rhat(jnp.asarray(store.numpy()), steps_major=True, return_moments=True)
    for a, b in zip((rhat, ess, mean, std), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=DIAG_RTOL, atol=1e-5)


def test_mh_slice_small_on_cpu():
    """The MH main path at a small size: Gaussian2D through
    ``MetropolisHastings(..., backend="cuda")`` and the diagnostics.  128
    chains of 600 steps after 200: about 2,400 effective draws, so the
    tolerances of tests/test_mh.py (mean 0.3, covariance 0.5) are four
    sampling errors wide."""
    import general_mcmc_torch as port

    mean, cov = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
    jt = gmt.Gaussian2D(mean=jnp.asarray(mean, jnp.float32), cov=jnp.asarray(cov, jnp.float32))
    target = to_target("Gaussian2D", np.asarray(jt.mean), np.asarray(jt.cov))
    x0 = to_tensor(np.asarray(gmt.init_det(128, 2)))
    samples = port.MetropolisHastings(target, port.RandomWalkProposal(1.0), x0, seed=0,
                                      backend="cuda", device="cpu").run(600, 200)
    assert tuple(samples.shape) == (128, 600, 2) and samples.dtype == torch.float32
    flat = samples.reshape(-1, 2).double()
    np.testing.assert_allclose(flat.mean(dim=0).numpy(), mean, atol=0.3)
    np.testing.assert_allclose(torch.cov(flat.T).numpy(), cov, atol=0.5)
    rhat, ess = split_rhat_mean_ess(samples.transpose(0, 1), steps_major=True)
    assert float(rhat.max()) < 1.1 and float(ess.min()) > 500


def test_logistic_slice_small_on_cpu():
    """The logistic path through the public names: data from the port's
    generator, the fused chain (its plain version on the CPU) climbs the
    non-centred target's log density."""
    import general_mcmc_torch as port
    from general_mcmc_torch.ops.fused_logistic import fused_logistic_chain

    X, y, _ = port.make_logistic_data(1, 64, 6, device="cpu")
    target = port.HierarchicalLogisticNC(X, y)
    gen = torch.Generator().manual_seed(2)
    theta0 = 0.1 * torch.randn((32, target.dim), generator=gen)
    theta = fused_logistic_chain(theta0, X, y, 50, lr=1e-3)
    assert tuple(theta.shape) == (32, 8) and bool(torch.isfinite(theta).all())
    assert bool((target.unnorm_logp(theta) > target.unnorm_logp(theta0)).all())


def test_no_port_file_imports_jax():
    """No file of the port nor chip_smoke.py has an import of jax or of the
    JAX package (their docstrings may name them)."""
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(_ROOT, "general_mcmc_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = re.compile(r"^\s*(import|from)\s+(jax|general_mcmc_tpu)\b", re.M)
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path


def test_package_imports_without_jax():
    """With ``jax`` unimportable, the package and chip_smoke's module-level
    imports load, and nothing of the JAX package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, pkgutil\n"
        "import general_mcmc_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('general_mcmc_tpu', 'jax'))\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": _ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target = to_target("GaussianND", np.zeros(2), np.ones(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HMC(target, torch.zeros(4, 2), 0.1, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HMC(target, torch.zeros(4, 2), 0.1, 3, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_with_seed(4, 2, 0)
    from general_mcmc_torch import Gaussian2D, MetropolisHastings, RandomWalkProposal

    mh_target = Gaussian2D([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    for backend in ("torch", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MetropolisHastings(mh_target, RandomWalkProposal(1.0), torch.zeros(4, 2),
                               backend=backend)
    MetropolisHastings(mh_target, RandomWalkProposal(1.0), torch.zeros(4, 2),
                       device="cpu").run(2)
    # named explicitly, the CPU runs
    HMC(target, torch.zeros(4, 2), 0.1, 3, device="cpu").run(2)
