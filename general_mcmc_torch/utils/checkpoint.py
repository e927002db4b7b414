"""Sampler checkpoint and resume: a carry saved to one ``.npz`` file.

Port of ``general_mcmc_tpu/utils/checkpoint.py``.  A carry is a tree of
dict, list, tuple and NamedTuple nodes (and ``None``) over tensor leaves.
The file holds the leaves as ``leaf_0, leaf_1, …`` and the structure as a
JSON description in ``__meta__``, not a pickle: loading never executes
pickle opcodes (``np.load(..., allow_pickle=False)``).  A NamedTuple node
is rebuilt by importing its class by module and qualname and checking that
it is a NamedTuple type, so loading can import a module present in the
environment but cannot run code chosen by the file.

Leaves:

- a tensor is written through ``.cpu()`` as a numpy array and comes back
  with its dtype on the device the caller names;
- a bfloat16 tensor, which numpy has no dtype for, is stored as its raw
  16-bit words (an ``int16`` array) with ``"bfloat16"`` in the meta, and
  comes back bit for bit;
- a Python ``bool``, ``int`` or ``float`` comes back as the same Python
  scalar, a numpy array as a numpy array.

The port's carries hold no random keys (draws are addressed by the
sampler's seed, :mod:`..rng`), so there is no key leaf kind; the sampler
stores its seed beside the carry (``BatchSampler.save_checkpoint``).
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import torch

from ..core import resolve_device

__all__ = ["save_carry", "load_carry"]


def _describe(node, leaves_out: list) -> dict:
    """Describe a carry's structure, appending its leaves in order to
    ``leaves_out``: dict, list, tuple, NamedTuple, None and leaf nodes."""
    if node is None:
        return {"t": "none"}
    if isinstance(node, dict):
        keys = list(node.keys())
        if any(not isinstance(k, str) for k in keys):
            raise TypeError("checkpoint dict keys must be strings")
        return {"t": "dict", "keys": keys,
                "children": [_describe(node[k], leaves_out) for k in keys]}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        cls = type(node)
        return {"t": "namedtuple", "module": cls.__module__, "qualname": cls.__qualname__,
                "children": [_describe(c, leaves_out) for c in node]}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "children": [_describe(c, leaves_out) for c in node]}
    leaves_out.append(node)
    return {"t": "leaf"}


def _resolve_namedtuple(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not (isinstance(obj, type) and issubclass(obj, tuple) and hasattr(obj, "_fields")):
        raise TypeError(f"{module}.{qualname} is not a NamedTuple type")
    return obj


def _rebuild(desc: dict, leaves: list):
    t = desc["t"]
    if t == "none":
        return None
    if t == "leaf":
        return leaves.pop(0)
    children = [_rebuild(c, leaves) for c in desc["children"]]
    if t == "dict":
        return dict(zip(desc["keys"], children))
    if t == "namedtuple":
        return _resolve_namedtuple(desc["module"], desc["qualname"])(*children)
    if t == "list":
        return children
    if t == "tuple":
        return tuple(children)
    raise ValueError(f"unknown checkpoint node type {t!r}")


def _encode(leaf):
    """``(numpy array, kind)`` of a leaf; the kind says how to rebuild it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), "tensor"
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), "py"
    if isinstance(leaf, np.ndarray):
        return leaf, "numpy"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _decode(arr: np.ndarray, kind: str, device):
    if kind == "py":
        return arr.item()
    if kind == "numpy":
        return arr
    t = torch.from_numpy(np.array(arr))
    if kind == "bfloat16":
        t = t.view(torch.bfloat16)
    elif kind != "tensor":
        raise ValueError(f"unknown checkpoint leaf kind {kind!r}")
    return t.to(device)


def save_carry(carry, path: str) -> str:
    """Write a carry to ``path`` (an ``.npz`` archive).  The archive goes
    through an open file handle, so the name on disk is exactly ``path``
    (``np.savez`` given a name would append ``.npz``).  Returns ``path``."""
    leaves: list = []
    structure = _describe(carry, leaves)
    arrays, kinds = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], kind = _encode(leaf)
        kinds.append(kind)
    meta = json.dumps({"structure": structure, "kinds": kinds})
    arrays["__meta__"] = np.frombuffer(meta.encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_carry(path: str, device=None):
    """Read a carry written by :func:`save_carry`, its tensors on
    ``device`` (``None``: the card, as every entry point; pass ``"cpu"``
    for the CPU)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(data["__meta__"].tobytes().decode("utf-8"))
        leaves = [_decode(data[f"leaf_{i}"], kind, dev)
                  for i, kind in enumerate(meta["kinds"])]
    return _rebuild(meta["structure"], leaves)
