"""The port's first slice end to end on the CPU: the benchmark target's
arrays carried over from the JAX package, HMC through the fused-run entry
point (its plain version, since the tensors lie on the CPU), and the
diagnostics, held against the target and against the JAX diagnostics on
the same sample.  Also: the package stands alone (no JAX), and entry points
refuse to run on a missing card."""

import os
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
    # named explicitly, the CPU runs
    HMC(target, torch.zeros(4, 2), 0.1, 3, device="cpu").run(2)
