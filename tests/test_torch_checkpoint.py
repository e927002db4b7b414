"""The port's checkpoints (general_mcmc_torch/utils/checkpoint.py) and
``save_checkpoint``/``resume`` on every port sampler: the counterparts of
tests/test_checkpoint.py.  Every comparison of a resumed run with the
uninterrupted one is ``torch.equal``: the draws are addressed by (key,
chain, absolute step), so a resumed segment replays the same numbers."""

import json
import os
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.samplers.metropolis_hastings import DiscreteWalkProposal
from general_mcmc_torch.utils import checkpoint
from general_mcmc_torch.utils.checkpoint import load_carry, save_carry
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


class _Pair(NamedTuple):
    a: torch.Tensor
    b: object


def _tree():
    return {
        "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
        "f64": torch.tensor([1.0 / 3.0, -2.5], dtype=torch.float64),
        "i32": torch.tensor([[1, -2], [3, 4]], dtype=torch.int32),
        "i64": torch.tensor(2**40, dtype=torch.int64),  # 0-d
        "bool": torch.tensor([True, False, True]),
        "bf16": torch.tensor([1.5, -3.0, 1e-3, 7e4], dtype=torch.bfloat16),
        "nested": (_Pair(torch.zeros(()), None), [1, 2.5, True], None),
        "np": np.arange(3, dtype=np.int16),
    }


def test_carry_roundtrip_every_node_and_leaf_dtype(tmp_path):
    path = str(tmp_path / "tree.npz")
    tree = _tree()
    back = load_carry(save_carry(tree, path), device="cpu")
    assert list(back) == list(tree)
    for k in ("f32", "f64", "i32", "i64", "bool", "bf16"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k]), k
    assert back["i64"].shape == ()
    pair, scalars, none = back["nested"]
    assert isinstance(back["nested"], tuple) and isinstance(pair, _Pair)
    assert torch.equal(pair.a, torch.zeros(())) and pair.b is None and none is None
    assert scalars == [1, 2.5, True] and type(scalars[0]) is int and type(scalars[2]) is bool
    assert back["np"].dtype == np.int16 and np.array_equal(back["np"], tree["np"])
    # bfloat16 is stored as its raw 16-bit words
    with np.load(path, allow_pickle=False) as data:
        kinds = json.loads(data["__meta__"].tobytes().decode())["kinds"]
        i = kinds.index("bfloat16")
        assert data[f"leaf_{i}"].dtype == np.int16


def test_sampler_carries_roundtrip(tmp_path):
    """A NUTS carry (dict, MassMatrix and Welford NamedTuples, int32/int64
    counters) and an MH tuple carry come back equal."""
    s = gmt.NUTS(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                 gmt.init_det(3, 2, device="cpu"), 0.8, max_tree_depth=3, seed=1,
                 mass_config=gmt.NUTSMassMatrixConfig(adaptation="dense"), device="cpu")
    s.run(5, 10)
    back = load_carry(save_carry(s._final_carry, str(tmp_path / "n.npz")), device="cpu")
    assert type(back["mass"]) is type(s._final_carry["mass"])
    assert type(back["welford"]) is type(s._final_carry["welford"])
    for k, v in s._final_carry.items():
        for a, b in zip(v if isinstance(v, tuple) else [v], back[k] if isinstance(v, tuple)
                        else [back[k]]):
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_exact_on_disk_name(tmp_path):
    path = str(tmp_path / "state")  # no extension
    assert save_carry({"x": torch.ones(2)}, path) == path
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    assert torch.equal(load_carry(path, device="cpu")["x"], torch.ones(2))


def test_load_never_unpickles(tmp_path, monkeypatch):
    path = save_carry({"x": torch.ones(2)}, str(tmp_path / "c.npz"))
    seen = []
    real = np.load

    def spy(*args, **kw):
        seen.append(kw.get("allow_pickle"))
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint.np, "load", spy)
    load_carry(path, device="cpu")
    assert seen == [False]


def test_non_namedtuple_qualname_refused(tmp_path):
    path = str(tmp_path / "evil.npz")
    meta = {"structure": {"t": "namedtuple", "module": "collections", "qualname": "OrderedDict",
                          "children": [{"t": "leaf"}]}, "kinds": ["tensor"]}
    with open(path, "wb") as f:
        np.savez(f, leaf_0=np.ones(2), __meta__=np.frombuffer(json.dumps(meta).encode(),
                                                               dtype=np.uint8))
    with pytest.raises(TypeError, match="not a NamedTuple"):
        load_carry(path, device="cpu")
    assert OrderedDict  # the class exists; it is refused for its type


def _nuts(**kw):
    return lambda: gmt.NUTS(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                            gmt.init_det(4, 2, device="cpu"), 0.8, device="cpu", **kw)


_FACTORIES = {
    "mh_f32": lambda: gmt.MetropolisHastings(gmt.Gaussian2D(MEAN, COV, device="cpu"),
                                             gmt.RandomWalkProposal(1.0),
                                             gmt.init_det(4, 2, device="cpu"), device="cpu"),
    "mh_f64": lambda: gmt.MetropolisHastings(
        gmt.Gaussian2D(MEAN, COV, device="cpu"), gmt.RandomWalkProposal(1.0),
        gmt.init_det(4, 2, dtype=torch.float64, device="cpu"), device="cpu"),
    "mh_int32": lambda: gmt.MetropolisHastings(gmt.Poisson(4.0), DiscreteWalkProposal(),
                                               torch.full((4, 1), 4, dtype=torch.int32),
                                               device="cpu"),
    "hmc": lambda: gmt.HMC(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                           gmt.init_det(4, 2, device="cpu"), 0.2, 5, device="cpu"),
    "nuts": _nuts(step_size=0.3),
    "nuts_static": _nuts(step_size=0.3, max_tree_depth=3, backend="static"),
    "nuts_multinomial": _nuts(step_size=0.3, proposal="multinomial", backend="torch"),
    "nuts_static_multinomial": _nuts(step_size=0.3, max_tree_depth=3, backend="static",
                                     proposal="multinomial"),
    "nuts_auto": _nuts(step_size=0.3, max_tree_depth=3, backend="auto"),
    "chees": lambda: gmt.ChEESHMC(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                                  gmt.init_det(4, 2, device="cpu"), step_size=0.3,
                                  trajectory_length=1.8, device="cpu"),
    "chees_static": lambda: gmt.ChEESHMC(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                                         gmt.init_det(4, 2, device="cpu"), step_size=0.3,
                                         trajectory_length=1.8, static_collection=True,
                                         device="cpu"),
}


@pytest.mark.parametrize("name", sorted(_FACTORIES))
@pytest.mark.parametrize("seed,total,k", [(0, 22, 9), (13, 22, 1)])
def test_resume_exactness_property(tmp_path, name, seed, total, k):
    """Checkpointing after K steps and resuming on a fresh sampler
    reproduces the uninterrupted run bit for bit, for every sampler and
    state dtype."""
    make = _FACTORIES[name]
    ref = make().seed(seed).run(total, 0)
    part = make().seed(seed)
    first = part.run(k, 0)
    path = str(tmp_path / f"{name}.npz")
    part.save_checkpoint(path)
    rest = make().seed(seed).resume(path, total - k)
    assert torch.equal(first, ref[:, :k]) and torch.equal(rest, ref[:, k:])


_WARM = {
    "chees": lambda: gmt.ChEESHMC(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                                  gmt.init_det(6, 2, device="cpu"), device="cpu"),
    "chees_static": lambda: gmt.ChEESHMC(gmt.DiffableGaussian2D(MEAN, COV, device="cpu"),
                                         gmt.init_det(6, 2, device="cpu"),
                                         static_collection=True, device="cpu"),
    "nuts_torch": _nuts(max_tree_depth=3, backend="torch",
                        mass_config=gmt.NUTSMassMatrixConfig(adaptation="diagonal")),
    "nuts_static": _nuts(max_tree_depth=3, backend="static",
                         mass_config=gmt.NUTSMassMatrixConfig(adaptation="diagonal")),
}


@pytest.mark.parametrize("name", sorted(_WARM))
def test_resume_after_warmup_equals_run(tmp_path, name):
    """run(N₁, K) + save_checkpoint + resume(N − N₁) on a fresh sampler
    equals run(N, K): no burn-in, the first resumed step at index K + N₁,
    the adapted state frozen."""
    make = _WARM[name]
    ref = make().seed(5).run(30, 40)
    part = make().seed(5)
    first = part.run(12, 40)
    path = str(tmp_path / "w.npz")
    part.save_checkpoint(path)
    rest = make().seed(5).resume(path, 18)
    assert torch.equal(torch.cat([first, rest], dim=1), ref)


def test_resume_keeps_the_checkpoint_stream(tmp_path):
    """A sampler of another seed resumes the checkpoint's stream, as a JAX
    checkpoint's keys ride in its carry; its own seed is left as it was and
    a checkpoint of the resumed run carries the stream on."""
    make = _FACTORIES["hmc"]
    ref = make().seed(7).run(30, 0)
    part = make().seed(7)
    part.run(10, 0)
    p1 = str(tmp_path / "a.npz")
    part.save_checkpoint(p1)
    other = make().seed(123)
    mid = other.resume(p1, 10)
    assert torch.equal(mid, ref[:, 10:20]) and other._key == 123
    p2 = str(tmp_path / "b.npz")
    other.save_checkpoint(p2)
    assert torch.equal(make().seed(5).resume(p2, 10), ref[:, 20:])
    # the other seed's own runs are untouched
    assert torch.equal(other.run(5, 0), make().seed(123).run(5, 0))


def test_chain_count_mismatch_raises(tmp_path):
    part = _FACTORIES["mh_f32"]()
    part.run(3, 0)
    path = str(tmp_path / "m.npz")
    part.save_checkpoint(path)
    wider = gmt.MetropolisHastings(gmt.Gaussian2D(MEAN, COV, device="cpu"),
                                   gmt.RandomWalkProposal(1.0), gmt.init_det(5, 2, device="cpu"),
                                   device="cpu")
    with pytest.raises(ValueError, match="4 chains"):
        wider.resume(path, 3)


@pytest.mark.parametrize("name", ["chees", "nuts_torch"])
def test_adapted_step_size_frozen_through_resume(tmp_path, name):
    s = _WARM[name]().seed(4)
    s.run(20, 50)
    eps_before = s.adapted_step_size.clone()
    path = str(tmp_path / "e.npz")
    s.save_checkpoint(path)
    fresh = _WARM[name]().seed(4)
    more = fresh.resume(path, 30)
    assert more.shape == (6 if name == "chees" else 4, 30, 2)
    assert bool(torch.isfinite(more).all())
    assert torch.equal(fresh.adapted_step_size, eps_before)
    assert fresh._steps_done == 100


def test_save_before_any_run_raises(tmp_path):
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        _FACTORIES["hmc"]().save_checkpoint(str(tmp_path / "x.npz"))


@pytest.mark.parametrize("kind", ["hmc", "mh"])
def test_fused_backend_run_keeps_no_carry(tmp_path, kind):
    """After a run of the fused kernel (here its plain version on the CPU)
    the step count is kept and there is no carry to checkpoint, as after
    the JAX package's Pallas run; a stale carry of an earlier run is
    dropped."""
    target = gmt.GaussianND([0.0, 0.0], [1.0, 2.0], device="cpu")
    x0 = gmt.init_det(4, 2, device="cpu")
    if kind == "hmc":
        s = gmt.HMC(target, x0, 0.3, 4, backend="cuda", device="cpu")
    else:
        s = gmt.MetropolisHastings(target, gmt.RandomWalkProposal(1.0), x0, backend="cuda",
                                   device="cpu")
    s.chain().step(3)
    assert hasattr(s, "_final_carry")
    s.run(5, 2, thin=2)
    assert s._steps_done == 12 and not hasattr(s, "_final_carry")
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        s.save_checkpoint(str(tmp_path / "f.npz"))
