"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``general_mcmc_torch/_build/``.  A source may be built in
variants, one for each set of macros it is given (the dense Gaussian's
kernels, one for each count of column blocks up to 168 dimensions (HMC) and
240 (MH): each build unrolls its solves fully; past them one streamed build,
``GMT_DENSE_WIDE``, whose count of blocks is a launch argument; the logistic
tile kernels, one for each count of feature tiles a
block, ``GMT_LOGISTIC_PT``, and past 256 features one cluster build,
``GMT_LOGISTIC_CLUSTER``, of 32 tiles a block whose cluster size is a launch
argument).  The file name carries a hash of the sources and the flags, so an
edited source is rebuilt and a stale library is never loaded.
Nothing is built when the package is imported: the CPU tests
import every module, and this machine may have no ``nvcc``.  A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build", "check", "variant", "BuildError", "compile_log", "OUT_DIR"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
OUT_DIR = _PKG / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# no contraction of a*b + c into one rounding: a kernel's elementwise
# arithmetic then rounds as its plain PyTorch version's separate ops do
_NO_FMA = ["-fmad=false"]
# Flags a source chooses for itself, in place of _NO_FMA.  The tile kernels'
# products (the logistic targets' one or two, the dense Gaussian's blocked solves)
# sum in another order than the plain version's library calls whatever the
# rounding (and on the tensor cores), so they agree to a tolerance either
# way and take the fused multiply-adds in their tile code (the HMC and MH
# kernels write the arithmetic around it with intrinsics that are never
# contracted, csrc/tile_hmc.cuh, csrc/tile_mh.cuh, csrc/fused_mh_logistic.cu).
_SOURCE_FLAGS: dict[str, list[str]] = {"fused_logistic": ["-fmad=true"],
                                       "fused_hmc_logistic": ["-fmad=true"],
                                       "fused_hmc_dense": ["-fmad=true"],
                                       "fused_mh_dense": ["-fmad=true"],
                                       "fused_mh_logistic": ["-fmad=true"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# build (a name or a variant) -> the compiler's output of the build done in
# this process (ptxas register and spill report); absent for a library found
# already built.
compile_log: dict[str, str] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found: the CUDA kernels build only on a machine "
                     "with the CUDA toolkit")


def variant(name: str, **defines) -> str:
    """The build of ``csrc/<name>.cu`` with the macros ``defines``, as
    :func:`build` and :func:`load` name it: ``name[KEY=value]...``."""
    return name + "".join(f"[{k}={v}]" for k, v in sorted(defines.items()))


def _parse(key: str):
    """``(source name, ["KEY=value", ...])`` of a build's key."""
    name, _, rest = key.partition("[")
    return name, rest.rstrip("]").split("][") if rest else []


def _flags(key: str) -> list[str]:
    name, defines = _parse(key)
    return _FLAGS + _SOURCE_FLAGS.get(name, _NO_FMA) + [f"-D{kv}" for kv in defines]


def _target(key: str) -> Path:
    name, defines = _parse(key)
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        raise BuildError(f"no CUDA source {src}")
    h = hashlib.sha256()
    for f in [src] + sorted(_CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(key)).encode())
    tag = "".join("-" + kv.replace("=", "") for kv in defines)
    return OUT_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def build(keys) -> dict[str, Path]:
    """Compile every build of ``keys`` (a source's name, or a
    :func:`variant`) that is not yet built, one ``nvcc`` process per build,
    all started together.  Returns the library paths."""
    targets = {k: _target(k) for k in keys}
    todo = {k: p for k, p in targets.items() if not p.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        src = _CSRC / f"{_parse(k)[0]}.cu"
        cmd = [nvcc, *_flags(k), "-I", str(_CSRC), "-o", str(tmp), str(src)]
        procs[k] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for k, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        compile_log[k] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {k} (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[k])
    if errors:
        raise BuildError("\n".join(errors))
    return targets


def load(name: str, **defines) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with the macros
    ``defines``, built first if needed."""
    key = variant(name, **defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = build([key])[key]
            lib = ctypes.CDLL(str(path))
            lib.gmt_error_string.argtypes = [ctypes.c_int]
            lib.gmt_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.gmt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
