"""What the tests of the ported examples (``tests/test_torch_examples*.py``)
share: loading an example by path, and their fixtures.

The examples of both packages share file names (``examples/`` and
``examples_torch/``), and ``tests/test_examples.py`` imports the JAX ones by
their bare names, so each is loaded here by path under a name of its own.
Not collected: no ``test_`` prefix."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

_REPO = Path(__file__).resolve().parent.parent
PORT_DIR = _REPO / "examples_torch"
JAX_DIR = _REPO / "examples"
_loaded = {}


def load(directory: Path, name: str):
    """The example ``name`` of ``directory``, loaded once under a name of
    its own.  The directory goes last on ``sys.path`` (the port's examples
    import ``_figure`` from theirs)."""
    key = (directory.name, name)
    if key not in _loaded:
        if str(directory) not in sys.path:
            sys.path.append(str(directory))
        spec = importlib.util.spec_from_file_location(f"{directory.name}_{name}",
                                                      directory / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def port(name: str):
    """The port's example ``name`` (``examples_torch/<name>.py``)."""
    return load(PORT_DIR, name)


def jax_example(name: str):
    """The JAX package's example ``name`` (``examples/<name>.py``)."""
    return load(JAX_DIR, name)


def out(mod, tmp_path):
    """``mod`` writing to ``tmp_path`` (an example reads ``EXAMPLE_OUT``
    once, when it is loaded)."""
    mod.OUT_DIR = str(tmp_path)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The examples' tensors at these sizes are tiny: one intra-op thread
    runs them fastest, and leaves the other cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def example_out(tmp_path, monkeypatch):
    monkeypatch.setenv("EXAMPLE_OUT", str(tmp_path))
    yield tmp_path
