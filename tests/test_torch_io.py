"""The port's export layer (general_mcmc_torch/io) against the JAX
package's: the shared chain/observation/dim_* schema, the CSV file byte for
byte (both write through csrc/fastio.cpp), round trips, refusals, the
pyarrow gate, and where the port builds its native writer."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from general_mcmc_tpu import io as jio
from general_mcmc_torch import _build
from general_mcmc_torch import io as pio
from general_mcmc_torch.io import native
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture
def sample():
    rng = np.random.default_rng(0)
    return rng.normal(size=(3, 5, 2)).astype(np.float64)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_table_equals_jax(sample, as_tensor):
    """Schema, types and rows of ``to_table`` equal the JAX package's, for
    a numpy array and for a tensor."""
    got = pio.to_table(torch.from_numpy(sample) if as_tensor else sample)
    want = jio.to_table(sample)
    assert got.schema.equals(want.schema)
    assert got.column_names == ["chain", "observation", "dim_0", "dim_1"]
    assert str(got.schema.field("chain").type) == "uint32"
    assert str(got.schema.field("dim_0").type) == "double"
    assert got.equals(want)
    row = got.to_pandas().iloc[7]  # chain 1, observation 2
    assert row["chain"] == 1 and row["observation"] == 2
    np.testing.assert_array_equal([row["dim_0"], row["dim_1"]], sample[1, 2])


def test_csv_byte_identical_to_jax(tmp_path, sample):
    """Both packages write through csrc/fastio.cpp: the same bytes, for a
    float64 array and for the float64 of a float32 tensor."""
    f32 = torch.from_numpy(sample).to(torch.float32)
    for name, data, host in (("f64", sample, sample), ("f32", f32, f32.numpy())):
        mine, theirs = tmp_path / f"port_{name}.csv", tmp_path / f"jax_{name}.csv"
        pio.save_csv(data, str(mine))
        jio.save_csv(host, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes(), name


@pytest.mark.parametrize("saver,suffix", [(pio.save_csv, "csv"), (pio.save_arrow, "arrow"),
                                          (pio.save_parquet, "parquet")])
def test_roundtrip(tmp_path, sample, saver, suffix):
    """Every format reads back exactly (CSV: shortest round-trip floats),
    also from a float32 tensor, as its float64."""
    path = str(tmp_path / f"out.{suffix}")
    saver(sample, path)
    np.testing.assert_array_equal(pio.load_table(path), sample)
    f32 = torch.from_numpy(sample).to(torch.float32)
    saver(f32, path)
    np.testing.assert_array_equal(pio.load_table(path), f32.double().numpy())
    np.testing.assert_array_equal(jio.load_table(path), f32.double().numpy())


def test_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError, match="chains, observations, dims"):
        pio.to_table(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="chains, observations, dims"):
        pio.save_csv(torch.zeros(3, 4), str(tmp_path / "bad.csv"))


def test_native_writer_is_the_ports_own(tmp_path, sample):
    """The port builds csrc/fastio.cpp into general_mcmc_torch/_build/ and
    loads that library, never the JAX package's; save_csv goes through it
    (``writes`` counts)."""
    assert native.native_write_csv_available()
    so = native.library_path()
    assert so.parent == Path(_build.OUT_DIR) and so.exists()
    assert Path(native._lib._name) == so
    assert "general_mcmc_tpu" not in str(so)
    before = native.writes
    pio.save_csv(sample, str(tmp_path / "n.csv"))
    assert native.writes == before + 1
    header = (tmp_path / "n.csv").read_text().splitlines()[0]
    assert header == "chain,observation,dim_0,dim_1"


def test_pyarrow_gate(tmp_path, sample, monkeypatch):
    """Without pyarrow, Arrow, Parquet, to_table and load_table raise an
    ImportError naming it, and CSV still writes through the native writer."""
    for mod in [m for m in sys.modules if m == "pyarrow" or m.startswith("pyarrow.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    for call in (lambda: pio.save_arrow(sample, str(tmp_path / "a.arrow")),
                 lambda: pio.save_parquet(sample, str(tmp_path / "a.parquet")),
                 lambda: pio.to_table(sample),
                 lambda: pio.load_table(str(tmp_path / "a.arrow"))):
        with pytest.raises(ImportError, match="pyarrow"):
            call()
    pio.save_csv(sample, str(tmp_path / "c.csv"))
    back = np.loadtxt(tmp_path / "c.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(back[:, 2:].reshape(sample.shape), sample)
