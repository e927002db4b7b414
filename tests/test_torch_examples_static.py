"""The ported examples (examples_torch/) on the CPU, part 3 of 4: the
static-window NUTS and ChEES examples of tests/test_examples.py, which run
at their own default sizes there too, under its gates."""

import numpy as np

from torch_examples import example_out, one_thread, port  # noqa: F401 (fixtures)


def test_static_window_nuts_example():
    sample = port("static_window_nuts").main(device="cpu")
    flat = sample.numpy().reshape(-1, 16)
    scales = np.exp(np.linspace(0.0, np.log(10.0), 16))
    np.testing.assert_allclose(flat.std(axis=0), scales, rtol=0.12)


def test_multinomial_nuts_example():
    results = port("multinomial_nuts").main(device="cpu")  # asserts shapes + R-hat
    assert set(results) == {"slice", "multinomial"}
    for rhat_max, min_ess in results.values():
        assert rhat_max < 1.05
        assert min_ess > 500


def test_chees_hmc_example():
    sample = port("chees_hmc").main(device="cpu")  # asserts R-hat + moment audit
    flat = sample.numpy().reshape(-1, 16)
    scales = np.exp(np.linspace(0.0, np.log(10.0), 16))
    np.testing.assert_allclose(flat.std(axis=0), scales, rtol=0.12)
