"""The ported examples (examples_torch/) on the CPU, part 4 of 4:
examples/auto_backend_nuts.py's port at its own default sizes, under the
gates of tests/test_examples.py (its second run is the dynamic tree at
doubling cap 10, the slowest example on the CPU)."""

import numpy as np

from torch_examples import example_out, one_thread, port  # noqa: F401 (fixtures)


def test_auto_backend_nuts_example():
    sample_a, sample_b = port("auto_backend_nuts").main(device="cpu")  # asserts choices
    for s in (sample_a, sample_b):
        flat = s.numpy()[:, 128:, :].reshape(-1, 8)
        assert np.abs(flat.mean(axis=0)).max() < 0.3
        np.testing.assert_allclose(flat.std(axis=0), 1.0, atol=0.25)
