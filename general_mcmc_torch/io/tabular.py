"""Sample export: CSV, Arrow IPC and Parquet.

Port of ``general_mcmc_tpu/io/tabular.py``: one tabular schema for a
``[chains, observations, dims]`` sample, columns ``chain:u32,
observation:u32, dim_0 … dim_{D−1}:f64``, rows in chain-major order
(io/csv.rs:54-56, io/arrow.rs:61-73, io/parquet.rs:53-66).  A sample may
be a tensor on the card: it is copied to the host once, as float64.

CSV goes through the repo's native writer (:mod:`.native`, the shared
``csrc/fastio.cpp``, shortest round-trip floats) and through pyarrow only
where that writer cannot be built, as in the JAX package.  Arrow, Parquet,
:func:`to_table` and :func:`load_table` need ``pyarrow`` (and
:func:`load_table` ``pandas``), imported at call time: the reference's
feature gates.  Without it they raise ``ImportError`` naming it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_csv", "save_arrow", "save_parquet", "to_table", "load_table"]


def _as_3d(data) -> np.ndarray:
    """``data`` as a float64 host array ``[chains, observations, dims]``,
    copied from the device once."""
    if isinstance(data, torch.Tensor):
        data = data.detach().to(device="cpu", dtype=torch.float64).numpy()
    arr = np.asarray(data)
    if arr.ndim != 3:
        raise ValueError(f"expected [chains, observations, dims], got {arr.shape}")
    return arr.astype(np.float64, copy=False)


def _pyarrow(module: str = "pyarrow"):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{module} is needed for this export format: pip install "
                          f"pyarrow ({e})") from e


def _table(arr: np.ndarray):
    pa = _pyarrow()
    c, s, d = arr.shape
    cols = {
        "chain": pa.array(np.repeat(np.arange(c, dtype=np.uint32), s)),
        "observation": pa.array(np.tile(np.arange(s, dtype=np.uint32), c)),
    }
    flat = arr.reshape(c * s, d)
    for i in range(d):
        cols[f"dim_{i}"] = pa.array(flat[:, i])
    return pa.table(cols)


def to_table(data):
    """A pyarrow ``Table`` in the shared export schema."""
    return _table(_as_3d(data))


def save_csv(data, filename: str) -> None:
    """Write the sample as CSV (save_csv, io/csv.rs:47-69) through the
    native writer, or through pyarrow where it cannot be built."""
    from .native import native_write_csv, native_write_csv_available

    arr = _as_3d(data)
    if native_write_csv_available():
        native_write_csv(arr, filename)
        return
    _pyarrow("pyarrow.csv").write_csv(_table(arr), filename)


def save_arrow(data, filename: str) -> None:
    """Write the sample as an Arrow IPC file (save_arrow, io/arrow.rs:53-117)."""
    table = to_table(data)
    pa = _pyarrow()
    with pa.OSFile(filename, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)


def save_parquet(data, filename: str) -> None:
    """Write the sample as Parquet (save_parquet, io/parquet.rs:49-109)."""
    table = to_table(data)
    _pyarrow("pyarrow.parquet").write_table(table, filename)


def load_table(filename: str) -> np.ndarray:
    """Read any of the three formats back into ``[chains, obs, dims]``
    float64."""
    pa = _pyarrow()
    if filename.endswith(".csv"):
        table = _pyarrow("pyarrow.csv").read_csv(filename)
    elif filename.endswith(".parquet"):
        table = _pyarrow("pyarrow.parquet").read_table(filename)
    else:
        with pa.OSFile(filename, "rb") as f:
            table = pa.ipc.open_file(f).read_all()
    df = table.to_pandas()
    n_chains = int(df["chain"].max()) + 1
    n_obs = int(df["observation"].max()) + 1
    dims = [c for c in df.columns if c.startswith("dim_")]
    out = df.sort_values(["chain", "observation"])[dims].to_numpy()
    return out.reshape(n_chains, n_obs, len(dims))
