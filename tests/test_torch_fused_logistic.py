"""The fused logistic gradient chain (general_mcmc_torch/ops/
fused_logistic.py), plain version on the CPU, against the JAX package's
Pallas probe ``scripts/exp_pallas_logistic.py`` run in interpret mode and
against its plain reference ``xla_chain``, at the script's small size (256
chains, p = 48, n_obs = 256).  The kernel itself is held against this plain
version on the card by chip_smoke.py."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_tpu.models.regression import make_logistic_data as jax_make_logistic_data
from general_mcmc_torch.convert import to_tensor
from general_mcmc_torch.ops import fused_logistic

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# After one step the two float32 programs differ by the rounding of one
# gradient (the script's own gate; 3.5e-7 measured on the CPU).  After eight
# the error measured on the CPU was 3.6e-6 against both the Pallas kernel
# and xla_chain; the limit leaves a factor of five.
RTOL_1_STEP, RTOL_8_STEPS = 1e-5, 2e-5


@pytest.fixture(scope="module")
def probe():
    """The script as a module, loaded by path; its ``main`` is guarded."""
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_logistic", os.path.join(_ROOT, "scripts", "exp_pallas_logistic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    X, y, _ = jax_make_logistic_data(jax.random.PRNGKey(1), 256, 48)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (256, 50), jnp.float32)
    return X, y, theta0


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


@pytest.mark.parametrize("steps,rtol", [(1, RTOL_1_STEP), (8, RTOL_8_STEPS)])
def test_chain_matches_jax_kernel_and_reference(probe, inputs, steps, rtol):
    X, y, theta0 = inputs
    kernel = np.asarray(probe.fused_chain(theta0, X, y, steps=steps, interpret=True))
    plain = np.asarray(probe.xla_chain(theta0, X, y, steps=steps)(theta0))
    got = fused_logistic.fused_logistic_chain(
        to_tensor(np.asarray(theta0)), to_tensor(np.asarray(X)), to_tensor(np.asarray(y)),
        steps, lr=1e-3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 50)
    assert _rel_err(got.numpy(), kernel) < rtol
    assert _rel_err(got.numpy(), plain) < rtol
    assert _rel_err(got.numpy(), np.asarray(theta0)) > 100 * rtol  # the chain moved


def test_wrapper_is_the_plain_version_on_the_cpu_and_checks_arguments(inputs):
    X, y, theta0 = (to_tensor(np.asarray(a)) for a in inputs)
    before = fused_logistic.launches
    got = fused_logistic.fused_logistic_chain(theta0[:8], X, y, 3, lr=2e-3)
    want = fused_logistic.fused_logistic_chain_reference(theta0[:8], X, y, 3, lr=2e-3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_logistic.launches == before  # no launch on the CPU
    assert torch.equal(fused_logistic.fused_logistic_chain(theta0[:8], X, y, 0), theta0[:8])
    run = fused_logistic.fused_logistic_chain
    with pytest.raises(ValueError, match="do not fit"):
        run(theta0[:, :49], X, y, 1)
    with pytest.raises(ValueError, match="do not fit"):
        run(theta0, X, y[:100], 1)
    with pytest.raises(ValueError, match="need theta0"):
        run(theta0[0], X, y, 1)
    with pytest.raises(ValueError, match="steps >= 0"):
        run(theta0, X, y, -1)
    with pytest.raises(ValueError, match="one device"):
        run(theta0.to("meta"), X, y, 1)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        run(theta0.to("meta"), X.to("meta"), y.to("meta"), 1)


def test_rounding_is_amplified_between_64_and_512_steps():
    """Why a 512-step comparison of two float32 programs cannot be tight: at
    the probe's step size the plain version in float32 stays within 1e-6 of
    itself in float64 for 64 steps and is more than 1e-3 away by 512 (256
    chains, the port's own data).  chip_smoke.py therefore holds the kernel
    to 1e-5 up to 64 steps and only loosely at 512."""
    import general_mcmc_torch as port

    X, y, _ = port.make_logistic_data(1, 256, 48, device="cpu")
    gen = torch.Generator().manual_seed(2)
    theta0 = 0.1 * torch.randn((256, 50), generator=gen)
    ref = fused_logistic.fused_logistic_chain_reference
    drift = {}
    for steps in (64, 512):
        f32 = ref(theta0, X, y, steps).double()
        f64 = ref(theta0.double(), X.double(), y.double(), steps)
        drift[steps] = float((f32 - f64).abs().max() / f64.abs().max())
    assert drift[64] < 1e-6, drift
    assert 1e-3 < drift[512] < 0.1, drift


def test_shared_memory_limits():
    """The probe's shape fits one block's shared memory; the limits are
    stated as module constants."""
    # rows of 48 + 4 floats, and y
    assert fused_logistic.shared_bytes(256, 48) == 4 * 256 * 53
    assert fused_logistic.shared_bytes(255, 33) == 4 * 256 * 53  # padded to even rows, 48 columns
    assert fused_logistic.shared_bytes(256, 48) <= fused_logistic.MAX_SHARED_BYTES
    assert fused_logistic.shared_bytes(2000, 48) > fused_logistic.MAX_SHARED_BYTES
    assert fused_logistic.MAX_FEATURES == 48
