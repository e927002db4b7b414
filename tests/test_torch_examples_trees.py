"""The ported examples (examples_torch/) on the CPU, part 2 of 4: the
dynamic-tree NUTS examples of tests/test_examples.py (the logistic
regressions, the tracked one, the funnel) at that file's cut sizes and
under its gates, and the sharded example on two gloo ranks against its
one-process run."""

import math
import os

import numpy as np

import torch_parallel_ranks as tpr
from torch_examples import example_out, one_thread, out, port  # noqa: F401 (fixtures)


def test_logistic_nuts():
    sample, beta_hat, beta_true = port("logistic_nuts").main(
        n_obs=120, n_features=4, n_chains=32, n_collect=150, n_warmup=150, device="cpu")
    assert tuple(sample.shape) == (32, 150, 6)
    # With 120 observations the posterior is wide; require only loose
    # recovery and the right sign structure for the strong coefficients.
    assert np.max(np.abs(beta_hat - beta_true)) < 1.5
    strong = np.abs(beta_true) > 0.5
    assert np.all(np.sign(beta_hat[strong]) == np.sign(beta_true[strong]))


def test_regression_nc_track():
    sample, stats, beta_true = port("regression_nc_track").main(
        n_obs=120, n_features=4, n_chains=32, n_collect=150, n_warmup=150, device="cpu")
    # tracked quantity is beta (p dims), not theta (p+2 dims)
    assert tuple(sample.shape) == (32, 150, 4)
    assert stats.rhat.max < 1.2  # R-hat computed on the transformed scale


def test_funnel_nuts(example_out):
    div_coarse, div_adapted, path = out(port("funnel_nuts"), example_out).main(
        n_chains=16, dim=6, n_collect=120, n_warmup=200, device="cpu")
    assert os.path.exists(path)
    assert div_coarse > div_adapted  # adaptation reduces divergences
    assert div_coarse > 0


def test_sharded_example_on_two_gloo_ranks(tmp_path):
    """The sharded example on two gloo ranks: every rank returns the whole
    sample, gathered from the blocks, and it equals the one-process run bit
    for bit (NUTS reduces nothing across chains)."""
    outs = tpr.spawn("example_sharded", 2, {"n": np.array(0)}, tmp_path)
    want = port("sharded_nuts").main(**tpr.EXAMPLE_SHARDED_ARGS, device="cpu")
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["sample"], want.numpy(), err_msg=f"rank {r}")
    assert math.isfinite(float(want.sum()))
