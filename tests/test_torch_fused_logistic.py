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
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

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


def _split_tf32(a):
    """``a = hi + lo`` as the kernel splits a float32 for the tensor cores:
    ``hi`` is the TF32 rounding to nearest, ties away from zero (half of the
    last kept place added to the bit pattern, then the low 13 of float32's
    mantissa bits masked off, leaving TF32's 10), ``lo`` the exact remainder
    rounded the same way."""
    mask = torch.tensor(-8192, dtype=torch.int32)  # 0xFFFFE000
    cut = lambda v: ((v.contiguous().view(torch.int32) + 0x1000) & mask).view(torch.float32)
    hi = cut(a)
    return hi, cut(a - hi)


def _matmul_3xtf32(a, b):
    """``a @ b`` by three TF32 passes accumulated in float32, small terms
    first.  A product of two TF32 values is exact in float32, so float32
    ``matmul`` of the cut operands is what the tensor cores compute up to
    the order of the sum."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _chain_3xtf32(theta, X, y, steps, lr=1e-3):
    """The kernel's arithmetic with torch ops: the plain chain with its two
    products replaced by the three-pass split."""
    for _ in range(steps):
        mu, lt, z = theta[:, :1], theta[:, 1:2], theta[:, 2:]
        tau = torch.exp(lt)
        g = _matmul_3xtf32(y - torch.sigmoid(_matmul_3xtf32(mu + tau * z, X.T)), X)
        grad = torch.cat([-mu + g.sum(dim=1, keepdim=True),
                          -lt + tau * (z * g).sum(dim=1, keepdim=True), -z + tau * g], dim=1)
        theta = theta + lr * grad
    return theta


def test_tf32_split_is_exact_and_one_pass_is_not_enough():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 48, generator=gen)
    b = torch.randn(48, 256, generator=gen)
    hi, lo = _split_tf32(a)
    assert bool(((hi.view(torch.int32) & 8191) == 0).all())  # 13 low bits clear
    assert bool(((a - hi).abs() <= a.abs() * 2.0**-11).all())  # rounded, not cut
    assert bool(((a - hi - lo).abs() <= a.abs() * 2.0**-22).all())
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err3 = float((_matmul_3xtf32(a, b).double() - exact).abs().max()) / scale
    err1 = float(((hi @ _split_tf32(b)[0]).double() - exact).abs().max()) / scale
    err_f32 = float(((a @ b).double() - exact).abs().max()) / scale
    assert err3 < 2e-6 and err3 < 10 * max(err_f32, 1e-7), (err3, err_f32)
    assert err1 > 100 * err3, (err1, err3)  # a single TF32 pass loses three digits


@pytest.mark.parametrize("steps", [1, 8, 64])
def test_three_pass_tf32_chain_meets_the_gate(probe, inputs, steps):
    """The accuracy argument for the tensor-core kernel, before any card
    time is spent: the chain with three-pass TF32 products stays within 1e-5
    (relative to max|θ|) of the plain version after 1, 8 and 64 steps, the
    gates chip_smoke.py holds the kernel to, and as close to the JAX probe
    in interpret mode as the plain version is."""
    X, y, theta0 = inputs
    tX, ty, tt = (to_tensor(np.asarray(a)) for a in (X, y, theta0))
    got = _chain_3xtf32(tt, tX, ty, steps)
    plain = fused_logistic.fused_logistic_chain_reference(tt, tX, ty, steps)
    assert _rel_err(got.numpy(), plain.numpy()) < 1e-5
    kernel = np.asarray(probe.fused_chain(theta0, X, y, steps=steps, interpret=True))
    limit = {1: RTOL_1_STEP, 8: RTOL_8_STEPS, 64: RTOL_8_STEPS}[steps]
    assert _rel_err(got.numpy(), kernel) < limit
    assert _rel_err(got.numpy(), np.asarray(theta0)) > 100 * limit  # the chain moved
    if steps == 1:
        # one TF32 pass alone would miss the gate's accuracy by far
        hi = lambda a: _split_tf32(a)[0]
        mu, lt, z = tt[:, :1], tt[:, 1:2], tt[:, 2:]
        one_pass = hi(ty - torch.sigmoid(hi(mu + torch.exp(lt) * z) @ hi(tX.T))) @ hi(tX)
        exact = (ty - torch.sigmoid((mu + torch.exp(lt) * z) @ tX.T)) @ tX
        assert float((one_pass - exact).abs().max() / exact.abs().max()) > 1e-4


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
    # X twice (TF32 hi and lo) in rows of 48 + 4 floats, y, and a tile's 12
    # units of beta fragments (hi, lo) and partial g (3 senders), 128 words
    # each, and 4 x 8 x 32 partial hyper sums
    one = 4 * (256 * (2 * 52 + 1) + 12 * 5 * 128 + 1024)
    assert fused_logistic.shared_bytes(256, 48) == one
    assert fused_logistic.shared_bytes(193, 33) == one  # padded to 64 rows, 48 columns
    assert fused_logistic.shared_bytes(256, 48, tiles=3) == one + 2 * 4 * (12 * 5 * 128 + 1024)
    assert fused_logistic.shared_bytes(256, 16) == 4 * (256 * (2 * 20 + 1) + 4 * 5 * 128 + 1024)
    # the probe's shape runs three tiles a block; 448 observations still fit one
    assert fused_logistic.shared_bytes(256, 48, tiles=3) <= fused_logistic.MAX_SHARED_BYTES
    assert fused_logistic.shared_bytes(448, 48) <= fused_logistic.MAX_SHARED_BYTES
    assert fused_logistic.shared_bytes(512, 48) > fused_logistic.MAX_SHARED_BYTES
    assert fused_logistic.MAX_FEATURES == 48
