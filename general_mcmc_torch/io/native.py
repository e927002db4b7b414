"""ctypes bridge to the repo's native CSV writer (``csrc/fastio.cpp``).

The port's own copy of ``general_mcmc_tpu/io/native.py``: it compiles the
shared ``csrc/fastio.cpp`` (which both packages use unchanged) with ``g++``
at first use into ``general_mcmc_torch/_build/``, under a name that carries
a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  It never loads the JAX package's library.
As in the JAX package, a writer that cannot be built or loaded is reported
by :func:`native_write_csv_available`, and ``save_csv`` then writes
through pyarrow.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import _build

__all__ = ["native_write_csv", "native_write_csv_available", "library_path", "writes"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "fastio.cpp"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False

# Files written by the native writer in this process.
writes = 0


def library_path() -> Path:
    """Where the writer's shared library is built: ``_build/libgmtio-<hash
    of the source and flags>.so``."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _build.OUT_DIR / f"libgmtio-{h.hexdigest()[:12]}.so"


def _find_or_build() -> Path:
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *_FLAGS, str(_SRC), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_find_or_build()))
        except (OSError, subprocess.SubprocessError):  # no source, compiler or loader
            return None
        lib.gmt_write_csv.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_uint32,
                                      ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p]
        lib.gmt_write_csv.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_write_csv_available() -> bool:
    return _load() is not None


def native_write_csv(data: np.ndarray, filename: str) -> None:
    """Write ``[chains, obs, dims]`` as CSV through the C++ writer."""
    global writes
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO kernel unavailable")
    arr = np.ascontiguousarray(data, dtype=np.float64)
    c, o, d = arr.shape
    rc = lib.gmt_write_csv(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), c, o, d,
                           os.fsencode(filename))
    if rc != 0:
        raise IOError(f"native CSV writer failed with code {rc}")
    writes += 1
