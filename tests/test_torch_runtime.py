"""The port's sampler runtime: ``chain``/``BatchChain``, ``track``, thinning,
``run_progress`` and its two runners, the streaming trackers, the progress
renderer and the small utilities.  Counterparts of tests/test_progress.py,
tests/test_static_tree.py (runtime composition) and tests/test_nuts_auto.py
(auto with checkpoint and resume), and comparisons with the JAX package on
the same inputs: the trackers, ``collect_rhat``, ``basic_stats``, the
renderer's strings and the stream runner's hook records."""

import dataclasses
import io
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch import core as pcore
from general_mcmc_torch.diagnostics import stats as pst
from general_mcmc_torch.samplers.metropolis_hastings import DiscreteWalkProposal
from general_mcmc_torch.utils import Timer, guard_finite, trace, validate_sample
from general_mcmc_torch.utils.progress import ProgressRenderer
from general_mcmc_tpu import core as jcore
from general_mcmc_tpu.diagnostics import stats as jst
from general_mcmc_tpu.utils.progress import ProgressRenderer as JaxRenderer
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-10  # float64 trackers: sums in another order only
RTOL_F32 = 1e-6  # the stream tracker runs in float32


def _mh(n_chains=4, seed=0):
    return gmt.MetropolisHastings(gmt.Gaussian2D([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]],
                                                 device="cpu"),
                                  gmt.RandomWalkProposal(1.0),
                                  gmt.init_det(n_chains, 2, device="cpu"), seed=seed,
                                  device="cpu")


def _states(steps=40, chains=6, params=3, seed=0):
    """Seeded states where some chains keep their state between steps, so
    that acceptance varies by chain."""
    rng = np.random.default_rng(seed)
    x = np.empty((steps, chains, params))
    x[0] = rng.normal(size=(chains, params))
    for t in range(1, steps):
        move = rng.random(chains) < np.linspace(0.2, 0.9, chains)
        x[t] = np.where(move[:, None], x[t - 1] + rng.normal(size=(chains, params)), x[t - 1])
    return x


# -- trackers against the JAX package ---------------------------------------------------
def test_multichain_tracker_matches_jax():
    x = _states()
    j = jst.MultiChainTracker(6, 3, dtype=jnp.float64)
    p = pst.MultiChainTracker(6, 3, dtype=torch.float64)
    for t in range(5):  # step by step, then one batch
        j.step(jnp.asarray(x[t]))
        p.step(torch.from_numpy(x[t]))
    j.step_batch(jnp.asarray(x[5:]))
    p.step_batch(torch.from_numpy(x[5:]))
    np.testing.assert_allclose(p.rhat().numpy(), np.asarray(j.rhat()), rtol=RTOL)
    np.testing.assert_allclose(p.p_accept, j.p_accept, rtol=RTOL)
    np.testing.assert_allclose(p.p_accept_chain.numpy(), np.asarray(j.p_accept_chain),
                               rtol=RTOL)
    np.testing.assert_allclose(p.max_rhat(), j.max_rhat(), rtol=RTOL)
    assert len(set(np.round(p.p_accept_chain.numpy(), 6))) > 1  # acceptance varies


def test_chain_tracker_collect_rhat_and_ess_match_jax():
    x = _states(steps=60)
    jt, pt = [], []
    for c in range(x.shape[1]):
        j = jst.ChainTracker(3, jnp.asarray(x[0, c]), dtype=jnp.float64)
        p = pst.ChainTracker(3, torch.from_numpy(x[0, c]), dtype=torch.float64)
        for t in range(1, x.shape[0]):
            j.step(jnp.asarray(x[t, c]))
            p.step(torch.from_numpy(x[t, c]))
        jt.append(j.stats())
        pt.append(p.stats())
    for a, b in zip(pt, jt):
        assert a.n == int(b.n)
        for f in ("p_accept", "mean", "sm2"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                       rtol=RTOL)
    np.testing.assert_allclose(pst.collect_rhat(pt).numpy(), np.asarray(jst.collect_rhat(jt)),
                               rtol=RTOL)
    # the JAX function casts the sample to float32: compare on a float32 sample
    sample = np.swapaxes(x[1:], 0, 1).astype(np.float32)
    got = pst.ess_from_chainstats(torch.from_numpy(sample), pt).numpy()
    np.testing.assert_allclose(got, np.asarray(jst.ess_from_chainstats(sample, jt)), rtol=1e-4)


def test_basic_stats_and_max_skipnan_match_jax():
    data = np.random.default_rng(3).normal(size=11)
    a, b = pst.basic_stats("x", torch.from_numpy(data)), jst.basic_stats("x", jnp.asarray(data))
    assert dataclasses.astuple(a) == dataclasses.astuple(b) and str(a) == str(b)
    assert pst.basic_stats("m", [1.0, 2.0, 3.0, 4.0]).median == 2.0  # index len//2, descending
    vals = [np.nan, 1.5, np.nan, 0.5]
    assert pst.max_skipnan(torch.tensor(vals)) == jst.max_skipnan(jnp.asarray(vals)) == 1.5
    assert np.isnan(pst.max_skipnan(torch.tensor([np.nan, np.nan])))


# -- the runners against the JAX package on a deterministic toy step --------------------
class _JaxToy:
    """A draw-free step in JAX: some chains move, the others keep their
    state, by a rule of the step and the chain.  XLA and torch round its
    arithmetic apart by an ulp at most, so states agree to rtol 1e-12."""

    def extract(self, c):
        return c

    def __call__(self, c, m):
        n, d = c.shape
        chain = jnp.arange(n)[:, None]
        move = ((m + chain) % 3) != 0
        kick = ((m * 7 + chain * 13 + jnp.arange(d) * 5) % 11 - 5).astype(c.dtype) * 0.1
        return jnp.where(move, kick - 0.5 * c, c)


class _TorchToy:
    def extract(self, c):
        return c

    def __call__(self, c, m):
        n, d = c.shape
        chain = torch.arange(n)[:, None]
        move = ((m + chain) % 3) != 0
        kick = ((m * 7 + chain * 13 + torch.arange(d) * 5) % 11 - 5).to(c.dtype) * 0.1
        return torch.where(move, kick - 0.5 * c, c)


def _toy_init(n=7, d=3):
    return np.random.default_rng(1).normal(size=(n, d))


def test_stream_hooks_match_jax():
    x0 = _toy_init()
    want, got = [], []
    rec = lambda out: lambda done, rhat, pacc, start, window: out.append(
        (int(done), float(rhat), float(pacc), int(start), np.asarray(window, np.float64)))
    jout = jcore.run_kernel_progress_stream(_JaxToy(), jnp.asarray(x0), 30, 13, rec(want),
                                            stride=8)
    pout = pcore.run_kernel_progress_stream(_TorchToy(), torch.from_numpy(x0), 30, 13,
                                            rec(got), stride=8)
    assert [r[0] for r in got] == [r[0] for r in want] == [8, 13, 21, 29, 37, 43]
    for a, b in zip(got, want):
        assert a[3] == b[3]
        np.testing.assert_allclose(a[1:3], b[1:3], rtol=RTOL_F32)
        np.testing.assert_allclose(a[4], b[4], rtol=RTOL_F32)
    np.testing.assert_allclose(pout.samples.numpy(), np.asarray(jout.samples), rtol=1e-12)
    np.testing.assert_allclose(pout.carry.numpy(), np.asarray(jout.carry), rtol=1e-12)


def test_chunked_runner_and_advance_match_jax():
    x0 = _toy_init()
    want, got = [], []
    jout = jcore.run_kernel_progress(_JaxToy(), jnp.asarray(x0), 20, 9,
                                     lambda d, s: want.append((d, np.asarray(s))), chunk=8)
    pout = pcore.run_kernel_progress(_TorchToy(), torch.from_numpy(x0), 20, 9,
                                     lambda d, s: got.append((d, s.numpy())), chunk=8)
    assert [d for d, _ in got] == [d for d, _ in want] == [8, 16, 24, 29]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(pout.samples.numpy(), np.asarray(jout.samples), rtol=1e-12)
    ja = jcore.advance_kernel(_JaxToy(), jnp.asarray(x0), 6, 11)
    pa = pcore.advance_kernel(_TorchToy(), torch.from_numpy(x0), 6, 11)
    np.testing.assert_allclose(pa.samples.numpy(), np.asarray(ja.samples), rtol=1e-12)
    assert pa.samples.shape == (6, 7, 3)


def test_renderer_strings_match_jax():
    """The port's renderer draws the JAX renderer's exact strings for the
    same numbers: a full-array tracker (rotated locally) and a stream
    window."""

    class Full:
        p_accept = 0.4567
        p_accept_chain = [0.1, -1.0, 0.333, 0.9, 0.5, 0.25, 0.75, 0.05]

        def max_rhat(self):
            return 1.0234

    class Window(Full):
        p_chain_is_window = True
        p_accept_chain_start = 6
        p_accept_chain = [0.2, 0.3, 0.4, 0.1, 0.6]

    outs = []
    for cls in (ProgressRenderer, JaxRenderer):
        buf = io.StringIO()
        r = cls(8, 100, min_interval=0.0, stream=buf)
        for done, t in ((10, Full()), (20, Full()), (64, Window()), (100, None)):
            r.update(done, t)
        r.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "Chain 6" in outs[0]


# -- the progress plumbing (tests/test_progress.py) ---------------------------------------
def test_renderer_draws_bars_and_stats():
    buf = io.StringIO()
    r = ProgressRenderer(n_chains=3, total_steps=100, stream=buf, min_interval=0.0)
    tracker = pst.MultiChainTracker(3, 2)
    tracker.step(torch.ones(3, 2))
    tracker.step(2.0 * torch.ones(3, 2))
    r.update(50, tracker)
    r.update(100, tracker)
    r.close()
    out = buf.getvalue()
    assert "Global" in out and "Chain 0" in out and "Chain 2" in out
    assert "p(accept)" in out and "max(rhat)" in out
    assert re.search(r"150/300", out) and re.search(r"300/300", out)


def test_renderer_per_chain_p_accept():
    buf = io.StringIO()
    r = ProgressRenderer(n_chains=3, total_steps=10, stream=buf, min_interval=0.0)
    tracker = pst.MultiChainTracker(3, 2)
    tracker.step(torch.tensor([[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]]))
    tracker.step(torch.tensor([[1.0, 1.0], [3.0, 1.0], [4.0, 2.0]]))
    r.update(5, tracker)
    chain_lines = [l for l in buf.getvalue().splitlines() if l.startswith("Chain")]
    vals = [re.search(r"p\(accept\)≈([\d.]+)", l) for l in chain_lines]
    assert all(v is not None for v in vals)
    assert float(vals[0].group(1)) < float(vals[1].group(1))  # chain 0 rejects
    assert vals[1].group(1) == vals[2].group(1)
    for _ in range(150):
        tracker.step(tracker._state.last_state + 1.0)
    buf2 = io.StringIO()
    ProgressRenderer(n_chains=3, total_steps=10, stream=buf2, min_interval=0.0).update(9, tracker)
    lines2 = [l for l in buf2.getvalue().splitlines() if l.startswith("Chain")]
    assert float(re.search(r"p\(accept\)≈([\d.]+)", lines2[0]).group(1)) > float(vals[0].group(1))


def test_renderer_caps_chain_bars():
    buf = io.StringIO()
    ProgressRenderer(n_chains=100, total_steps=10, stream=buf, min_interval=0.0).update(10, None)
    out = buf.getvalue()
    assert "Chain 4" in out and "Chain 5" not in out


def test_run_progress_renders(capsys):
    sample, stats = _mh(2, seed=1).run_progress(50, 10, progress=True)
    assert "Global" in capsys.readouterr().err
    assert sample.shape == (2, 50, 2) and isinstance(stats, pst.RunStats)


@pytest.mark.parametrize("mode", ["stream", "chunked"])
def test_progress_modes_match_run_exactly(mode):
    """Neither progress mode perturbs the stream: the samples equal a plain
    run's, with a tail that is not a multiple of the stride."""
    ref = _mh(seed=7).run(75, 33)
    sample, stats = _mh(seed=7).run_progress(75, 33, progress=False, mode=mode)
    assert torch.equal(sample, ref)
    want = pst.RunStats.from_sample(ref)
    assert stats.rhat == want.rhat and stats.ess == want.ess


def test_stream_mode_hook_cadence_and_values():
    mh = _mh(seed=2)
    mh._prepare_run(100, 60)
    ticks = []
    out = pcore.run_kernel_progress_stream(
        mh._step_fn, mh._init_carry(), 100, 60,
        lambda done, rhat, pacc, start, pchain: ticks.append((done, float(rhat), float(pacc))),
        stride=64)
    assert out.samples.shape == (100, 4, 2)
    assert [t[0] for t in ticks] == [60, 124, 160]
    assert 0.5 < ticks[-1][1] < 3.0 and 0.0 <= ticks[-1][2] <= 1.0


def test_single_step_runstats_nan_not_crash():
    sample, stats = _mh(seed=1).run_progress(1, 3, progress=False, mode="stream")
    assert sample.shape == (4, 1, 2)
    assert np.isnan(stats.rhat.mean)


def test_stream_mode_renders(capsys):
    sample, _ = _mh(2, seed=1).run_progress(50, 10, progress=True, mode="stream")
    err = capsys.readouterr().err
    assert "Global" in err and "max(rhat)" in err
    assert sample.shape == (2, 50, 2)


def test_stream_mode_int_states():
    mh = gmt.MetropolisHastings(gmt.Poisson(4.0), DiscreteWalkProposal(),
                                torch.full((4, 1), 4, dtype=torch.int32), seed=1, device="cpu")
    s, _ = mh.run_progress(80, 20, progress=False, mode="stream")
    assert s.shape == (4, 80, 1) and s.dtype == torch.int32
    ref = gmt.MetropolisHastings(gmt.Poisson(4.0), DiscreteWalkProposal(),
                                 torch.full((4, 1), 4, dtype=torch.int32), seed=1,
                                 device="cpu").run(80, 20)
    assert torch.equal(s, ref)


def test_stream_mode_p_accept_matches_chunked():
    mh = _mh(seed=4)
    mh._prepare_run(64, 0)
    ticks = []
    out = pcore.run_kernel_progress_stream(
        mh._step_fn, mh._init_carry(), 64, 0,
        lambda done, rhat, pacc, start, pchain: ticks.append((done, float(pacc), start, pchain)),
        stride=64)
    tracker = pst.MultiChainTracker(4, 2)
    tracker.step_batch(out.samples)
    assert ticks[0][0] == 64
    assert abs(ticks[0][1] - tracker.p_accept) < 1e-5 and 0.0 <= ticks[0][1] <= 1.0
    start, window = ticks[0][2], ticks[0][3]
    idx = (start + np.arange(len(window))) % 4
    np.testing.assert_allclose(window, tracker.p_accept_chain.numpy()[idx], atol=1e-5)


@pytest.mark.parametrize("mode", ["chunked", "stream"])
def test_steps_done_after_run_progress(tmp_path, mode):
    mh = _mh(seed=8)
    mh.run_progress(30, 10, progress=False, mode=mode)
    assert mh._steps_done == 40
    p = str(tmp_path / f"{mode}.npz")
    mh.save_checkpoint(p)
    ref = _mh(seed=8).run(45, 10)
    assert torch.equal(_mh(seed=8).resume(p, 15), ref[:, 30:])


def test_chain_bar_rotation_cycles_all_chains():
    buf = io.StringIO()
    r = ProgressRenderer(8, 100, min_interval=0.0, stream=buf)

    class T:
        p_accept = 0.5
        p_accept_chain = [0.5] * 8

        def max_rhat(self):
            return 1.0

    for step in range(8):
        r.update(step + 1, T())
    out = buf.getvalue()
    for i in range(8):
        assert f"Chain {i}" in out


def test_auto_mode_selects_by_staged_bytes(monkeypatch):
    """``"auto"`` picks chunked for a small run and stream above the byte
    rule; the choice shows in which runner is called."""
    calls = []
    for name in ("run_kernel_progress", "run_kernel_progress_stream"):
        real = getattr(gmt.samplers.base, name)
        monkeypatch.setattr(gmt.samplers.base, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    mh = _mh(seed=3)
    assert (30 + 10) * 4 * 2 * 4 <= mh._AUTO_STREAM_BYTES
    s_small, _ = mh.run_progress(30, 10, progress=False)
    mh2 = _mh(seed=3)
    mh2._AUTO_STREAM_BYTES = 0
    s_stream, _ = mh2.run_progress(30, 10, progress=False)
    assert calls == ["run_kernel_progress", "run_kernel_progress_stream"]
    assert torch.equal(s_stream, s_small)
    with pytest.raises(ValueError, match="unknown progress mode"):
        mh.run_progress(3, 0, progress=False, mode="bogus")


def test_stream_window_indexing_small_chain_count():
    buf = io.StringIO()
    r = ProgressRenderer(4, 100, min_interval=0.0, stream=buf)

    class T:
        p_accept = 0.5
        p_chain_is_window = True
        p_accept_chain_start = 1
        p_accept_chain = [0.20, 0.30, 0.40, 0.10]

        def max_rhat(self):
            return 1.0

    r.update(10, T())
    out = buf.getvalue()
    for chain, val in ((1, 0.20), (2, 0.30), (3, 0.40), (0, 0.10)):
        line = next(l for l in out.splitlines() if l.startswith(f"Chain {chain} "))
        assert f"{val:.2f}" in line


def _static_nuts(seed=9, dim=2, scales=(1.0, 1.0), depth=3, eps=0.5, n=8):
    t = gmt.GaussianND([0.0] * dim, list(scales), device="cpu")
    return gmt.NUTS(t, gmt.init_det(n, dim, device="cpu"), 0.8, max_tree_depth=depth,
                    step_size=eps, backend="static", seed=seed, device="cpu")


def test_stream_mode_static_nuts_matches_run():
    ref = _static_nuts().run(40, 12)
    sample, _ = _static_nuts().run_progress(40, 12, progress=False, mode="stream")
    assert torch.equal(sample, ref)


# -- chain, track and thin (tests/test_static_tree.py) ------------------------------------
def test_static_backend_composes_with_track_thin_chain():
    mk = lambda: _static_nuts(seed=21, dim=3, scales=(1.0, 4.0, 0.25), eps=0.4)
    full = mk().run(20, 6)
    assert torch.equal(mk().run(10, 6, thin=2), full[:, 1::2])
    tracked = mk().track(lambda x: x[:, :1] + x[:, 1:2]).run(20, 6)
    assert torch.equal(tracked[:, :, 0], full[:, :, 0] + full[:, :, 1])
    ch = mk().chain(n_warmup=6)
    ch.step(6)
    assert torch.equal(ch.step(20), full) and ch.steps_done == 26
    assert torch.equal(ch.current_state(), full[:, -1])


_MEAN, _COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _sampler(name, seed=3):
    x0 = gmt.init_det(6, 2, device="cpu")
    target = gmt.DiffableGaussian2D(_MEAN, _COV, device="cpu")
    if name == "hmc":
        return gmt.HMC(target, x0, 0.2, 5, seed=seed, device="cpu")
    if name == "chees":
        return gmt.ChEESHMC(target, x0, seed=seed, device="cpu")
    if name == "chees_static":
        return gmt.ChEESHMC(target, x0, seed=seed, static_collection=True, device="cpu")
    return gmt.NUTS(target, x0, 0.8, seed=seed, max_tree_depth=3, backend=name[5:],
                    mass_config=gmt.NUTSMassMatrixConfig(adaptation="diagonal"), device="cpu")


@pytest.mark.parametrize("name", ["hmc", "chees", "nuts_torch", "nuts_static"])
def test_chain_then_steps_equals_run(name):
    """chain(K), step(K), step(N) visits exactly run(N, K)'s states, and the
    sampler stays checkpointable at the chain's frontier."""
    ref = _sampler(name).run(20, 16)
    s = _sampler(name)
    ch = s.chain(16)
    ch.step(16)
    assert torch.equal(ch.step(20), ref)
    assert s._steps_done == 36 and s._final_carry is ch._carry


@pytest.mark.parametrize("name", ["hmc", "chees", "chees_static", "nuts_torch", "nuts_static"])
def test_track_and_progress_equal_run(name):
    """track(f).run is f of run (static ChEES collection included), and
    both progress modes give run's samples; track(None) restores the
    positions."""
    f = lambda x: torch.stack([x[:, 0] - x[:, 1], x[:, 0] * x[:, 1]], dim=1)
    ref = _sampler(name).run(20, 16)
    s = _sampler(name).track(f)
    assert torch.equal(s.run(20, 16), f(ref.reshape(-1, 2)).reshape(6, 20, 2))
    assert torch.equal(s.track(None).run(20, 16), ref)
    for mode in ("stream", "chunked"):
        got, _ = _sampler(name).run_progress(20, 16, progress=False, mode=mode)
        assert torch.equal(got, ref), mode


@pytest.mark.parametrize("name", ["chees", "nuts_torch"])
def test_chain_keeps_its_schedule_across_runs(name):
    """A run of the sampler between two steps of an open chain does not
    change the chain's warmup gate or window schedule (both are bound into
    its step function)."""
    ref = _sampler(name).run(20, 16)
    s = _sampler(name)
    ch = s.chain(16)
    ch.step(10)
    s.run(5, 3)
    ch.step(6)
    assert torch.equal(ch.step(20), ref)


def test_chees_chain_runs_the_adaptive_law():
    """chain() steps the adaptive law throughout, as the JAX package's
    incremental driver: on a static-collection sampler it equals the
    adaptive sampler's run, not the static one's."""
    ch = _sampler("chees_static").chain(16)
    ch.step(16)
    assert torch.equal(ch.step(20), _sampler("chees").run(20, 16))


def test_auto_checkpoint_resume(tmp_path):
    """resume() on the sampler that ran continues under its resolved
    backend; the resumed trajectory equals the uninterrupted one."""
    std_normal = lambda x: -0.5 * torch.sum(x * x, dim=-1)
    mk = lambda: gmt.NUTS(std_normal, gmt.init_det(8, 3, device="cpu"), 0.8, max_tree_depth=3,
                          step_size=0.05, backend="auto", seed=7, device="cpu")
    want = mk().run(24, 16)
    part = mk()
    first = part.run(12, 16)
    assert part.backend_selected == "static"
    path = str(tmp_path / "ck.npz")
    part.save_checkpoint(path)
    rest = part.resume(path, 12)
    assert torch.equal(torch.cat([first, rest], dim=1), want)
    # a fresh auto sampler has resolved nothing and resumes on the dynamic
    # tree, as a "torch" sampler does
    torch_nuts = gmt.NUTS(std_normal, gmt.init_det(8, 3, device="cpu"), 0.8, max_tree_depth=3,
                          step_size=0.05, backend="torch", device="cpu")
    assert torch.equal(mk().resume(path, 12), torch_nuts.resume(path, 12))


# -- utilities ---------------------------------------------------------------------------------
def test_timer_validate_guard_and_trace(tmp_path, capsys):
    t = Timer()
    assert t.log("step", block_on={"a": torch.ones(2), "b": [torch.zeros(1)]}) >= 0.0
    assert re.match(r"\[\d+\.\d{3}s\] step", capsys.readouterr().out)
    good = torch.zeros(3, 4, 2)
    validate_sample(good)
    bad = good.clone()
    bad[1, 2, 0] = float("nan")
    bad[2, 0, 1] = float("inf")
    with pytest.raises(FloatingPointError, match=r"chains \[1, 2\] \(2/3"):
        validate_sample(bad, "s")
    assert guard_finite(good) is good and capsys.readouterr().out == ""
    guard_finite(bad, "draws")
    assert "WARNING: non-finite draws detected" in capsys.readouterr().out
    with trace(str(tmp_path / "tr"), block_on_exit=good):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_port_imports_no_jax():
    """Nothing under general_mcmc_torch/ and nothing in chip_smoke.py
    imports jax or the JAX package."""
    files = sorted((REPO / "general_mcmc_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|general_mcmc_tpu)\b", re.M)
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert len(files) > 20 and offenders == []
