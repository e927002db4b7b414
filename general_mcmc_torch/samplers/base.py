"""Shared batch-sampler runtime.

Port of ``general_mcmc_tpu/samplers/base.py``: chain state is a batch with
a leading ``[n_chains]`` axis, one transition is a function
``carry, m -> carry`` of the absolute step index ``m``, and a run is
burn-in followed by collection (:func:`..core.run_kernel`).  Randomness is
addressed by (stream key, global chain index, step), the counterpart of
the JAX package's per-chain Threefry keys.

Every sampler inherits the runtime around its step: ``run``, incremental
driving (:meth:`BatchSampler.chain`, :class:`BatchChain`), derived
quantities (:meth:`BatchSampler.track`), checkpoints
(:meth:`BatchSampler.save_checkpoint`, :meth:`BatchSampler.resume`) and
progress with streaming R-hat (:meth:`BatchSampler.run_progress`).

A sampler may be one rank's block of a run split over ranks
(:func:`..parallel.runner.run_sharded`): it then holds a
:class:`..parallel.mesh.Shard` in ``shard`` (``None`` when unsharded):
its first global chain and coordinate, its local and total chain and
coordinate counts, and its chains and dim groups.  ``n_chains`` is then the
local count, every draw is addressed from the block's first global chain
(and, on the dim axis, coordinate), and every reduction across chains or
coordinates goes through the shard's groups.  On the dim axis the target is
:func:`..models.distributions.column_block`'s block (its own column block,
or one that gathers whole rows), and whatever else couples coordinates (a
dense metric, a Gibbs sweep) gathers the rows too (:attr:`_gather`).
A fused kernel holds whole rows, so ``backend="cuda"`` has no dim axis.

The JAX carry holds each chain's key, so a JAX checkpoint continues its
own stream whatever seed the resuming sampler holds.  The port's carry
holds no keys: the draws of a step are addressed by the sampler's seed.
So a checkpoint stores the stream key its carry was drawn under beside
the carry, and :meth:`BatchSampler.resume` draws under that key, which
keeps JAX's behaviour.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from ..core import (
    advance_kernel,
    resolve_device,
    run_kernel,
    run_kernel_progress,
    run_kernel_progress_stream,
)
from ..diagnostics.stats import MultiChainTracker, RunStats
from ..models.distributions import column_block
from ..parallel.collectives import col_gather
from ..parallel.mesh import Shard
from ..rng import as_seed, chain_ids, stream_key
from ..utils.progress import ProgressRenderer

__all__ = ["BatchSampler", "BatchChain"]


class BatchChain:
    """Incremental driving of all chains: create it with
    :meth:`BatchSampler.chain`, call :meth:`step` repeatedly and read
    :meth:`current_state` between calls.  Step indices are absolute and
    continue across calls, and the draws stay under the key the chain was
    opened with, so ``step(K); step(N)`` after ``chain(K)`` visits exactly
    the states of ``run(N, K)``."""

    def __init__(self, sampler: "BatchSampler", carry):
        self._sampler = sampler
        self._step_fn = sampler._step_fn
        self._carry = carry
        self._key = sampler._key
        self._m = 0

    @property
    def steps_done(self) -> int:
        return self._m

    def current_state(self):
        """The tracked state ``[n_chains, k]`` (positions, or the
        :meth:`BatchSampler.track` map of them)."""
        return self._step_fn.extract(self._carry)

    def step(self, n: int = 1):
        """Advance all chains ``n`` steps; returns the ``[n_chains, n, k]``
        block of post-step tracked states.  The owning sampler keeps the
        frontier, so it can be checkpointed after any call."""
        with self._sampler._drawing_under(self._key):
            out = advance_kernel(self._step_fn, self._carry, n, self._m)
            self._carry = out.carry
            self._m += n
            self._sampler._keep(out.carry, self._m)
        return out.samples.transpose(0, 1)


class _StepFn:
    """A step function with the ``extract`` map the runner records."""

    def __init__(self, step: Callable, extract: Callable):
        self._step = step
        self.extract = extract

    def __call__(self, carry, m):
        return self._step(carry, m)


class _LatestStats:
    """The renderer's view of the last streamed tick: max R-hat, p_accept
    and the rotated window of per-chain acceptance EWMAs."""

    p_accept = float("nan")
    p_accept_chain = None
    p_accept_chain_start = 0
    p_chain_is_window = True  # p_accept_chain is a pre-rotated window
    _max_rhat = float("nan")

    def max_rhat(self) -> float:
        return self._max_rhat


class BatchSampler:
    """Base class: subclasses implement ``_init_carry``, ``_step`` and
    ``_positions`` and inherit ``run``, ``chain``, ``track``,
    ``save_checkpoint``, ``resume``, ``run_progress`` and ``set_seed``."""

    # The attribute that holds the [n_chains, dim] initial states.
    _init_name = "initial_positions"

    def __init__(self, n_chains: int, seed=None, device=None):
        self.n_chains = n_chains
        self.shard = None
        self.device = resolve_device(device)
        self._seed = as_seed(seed if seed is not None else 0)
        self._extract_fn = None
        self._step_fn = self._make_step_fn()

    def _make_step_fn(self, step: Callable | None = None) -> _StepFn:
        """The runner-facing step function: ``step`` (default ``_step``)
        with the ``track`` map, if any, composed over ``_positions``."""
        step = step if step is not None else self._step
        fn = self._extract_fn
        if fn is None:
            return _StepFn(step, self._positions)
        return _StepFn(step, lambda carry: fn(self._positions(carry)))

    def track(self, extract_fn: Callable | None):
        """Record ``extract_fn(positions)`` (``[n_chains, dim] -> [n_chains,
        k]``) instead of the positions: collected samples, streaming
        progress statistics and post-run diagnostics then all see the
        derived quantities (e.g. β = μ + τ·z of a non-centred hierarchical
        model).  ``None`` restores the raw positions.  Returns ``self``."""
        self._extract_fn = extract_fn
        self._step_fn = self._make_step_fn()
        return self

    # -- subclass interface -------------------------------------------------
    def _prepare_run(self, n_collect: int, n_discard: int) -> None:
        """Called before each run: samplers with state that depends on the
        run's lengths (warmup gates, window schedules) set it here."""

    def _collection_fn(self, carry) -> _StepFn:
        """The step function of the collection phase, given the post-warmup
        carry (``run_progress`` and ``resume``): ``_step_fn`` here."""
        return self._step_fn

    def _init_carry(self) -> Any:
        raise NotImplementedError

    def _step(self, carry, m):
        raise NotImplementedError

    def _positions(self, carry):
        raise NotImplementedError

    def _carry_axes(self, carry):
        """The carry's structure with an :class:`..parallel.mesh.Axes` at
        each leaf: where it holds the chains axis and the parameter axis
        (what ``parallel.shard_carry`` slices by)."""
        raise NotImplementedError

    # -- shards ---------------------------------------------------------------
    @property
    def _chain0(self) -> int:
        """The global index of this sampler's first chain."""
        return 0 if self.shard is None else self.shard.chain0

    @property
    def _word0(self) -> int:
        """The global index of this sampler's first coordinate: the first
        word of its momentum normals."""
        return 0 if self.shard is None else self.shard.col0

    @property
    def _n_total(self) -> int:
        """The chains of the whole run, on every rank."""
        return self.n_chains if self.shard is None else self.shard.n_total

    @property
    def _chains_group(self):
        return None if self.shard is None else self.shard.chains_group

    @property
    def _dim_group(self):
        return None if self.shard is None else self.shard.dim_group

    @property
    def _dim_total(self) -> int:
        """The coordinates of the whole run."""
        if self.shard is not None:
            return self.shard.d_total
        return getattr(self, self._init_name).shape[-1]

    @property
    def _gather(self):
        """``x ->`` the rows' whole states from this block's columns ``x``
        (:func:`..parallel.collectives.col_gather`; ``x`` itself
        unsharded)."""
        return col_gather(self._dim_group, self._word0, self._dim_total)

    def _check_dim_axis(self) -> None:
        """Raise unless this sampler can split the parameter axis over
        ranks: every ``"torch"`` step can; a fused kernel holds whole rows
        (JAX's ``run_sharded`` never reaches its Pallas kernel either: it
        drives the XLA step)."""
        if getattr(self, "backend", None) == "cuda":
            raise NotImplementedError(
                f"{type(self).__name__}(backend='cuda') has no dim axis: a fused kernel "
                "holds whole rows; run shard_dim=True with backend='torch'")

    def _take_columns(self, shard) -> None:
        """Restrict the target to the shard's coordinates
        (:func:`..models.distributions.column_block`) and rebind what the
        sampler derives from it (:meth:`_bind_target`); a sampler with
        other parameter-axis state slices it too."""
        self.target = column_block(self.target, shard.col0, shard.col0 + shard.d_local,
                                   shard.dim_group, shard.d_total)
        self._bind_target()

    def _bind_target(self) -> None:
        """Derive the sampler's density functions from ``self.target``."""

    def _bind_shard(self, shard, slice_rows: bool, shard_dim: bool = False) -> None:
        """Make this sampler the block ``shard`` of itself
        (``parallel.runner.shard_sampler``): slice its initial states to the
        block's rows (``slice_rows``: it was built on the whole array) and
        with ``shard_dim`` to its columns, and its target to those columns.
        Binding again to an equal block is a no-op; to another, an error."""
        if self.shard is not None:
            if shard != self.shard:
                raise ValueError("this sampler already holds another block of a sharded "
                                 "run; build a new sampler for another mesh")
            return
        if shard_dim:
            self._check_dim_axis()
            if shard.d_local != shard.d_total:
                self._take_columns(shard)
        x = getattr(self, self._init_name)
        if slice_rows:
            x = x[shard.chain0:shard.chain0 + shard.n_local]
        if shard.d_local != shard.d_total:
            x = x[:, shard.col0:shard.col0 + shard.d_local]
        if x is not getattr(self, self._init_name):
            setattr(self, self._init_name, x.clone())  # the whole array can be freed
        self.n_chains = shard.n_local
        self.shard = shard

    def _address_rows_from(self, chain0: int) -> None:
        """Draw this sampler's rows as the global chains ``chain0 …`` (a
        block of chains with no group to reduce over: the fused kernels'
        plain versions take their ``chain0`` so)."""
        if chain0:
            d = self._dim_total
            self._bind_shard(Shard(chain0=chain0, n_local=self.n_chains,
                                   n_total=chain0 + self.n_chains, col0=0, d_local=d,
                                   d_total=d, chains_group=None, dim_group=None),
                             slice_rows=False)

    # -- seeding ------------------------------------------------------------
    def set_seed(self, seed):
        self._seed = as_seed(seed)
        return self

    seed = set_seed

    @property
    def _key(self) -> int:
        """The 31-bit counter-generator key of this sampler's seed."""
        return stream_key(self._seed)

    @property
    def _chain_ids(self) -> torch.Tensor:
        """Global chain indices, the chain coordinate of every draw."""
        return chain_ids(self.n_chains, self.device, self._chain0)

    @contextlib.contextmanager
    def _drawing_under(self, key: int):
        """Draw under stream key ``key`` inside the block (a checkpoint's,
        or an open chain's), whatever the sampler's seed."""
        saved = self._seed
        self._seed = key
        try:
            yield
        finally:
            self._seed = saved

    def _keep(self, carry, steps_done: int) -> None:
        """Keep a run's last carry, its absolute step count and the key it
        was drawn under: what :meth:`save_checkpoint` writes."""
        self._final_carry = carry
        self._steps_done = steps_done
        self._carry_key = self._key

    def _drop_carry(self, steps_done: int) -> None:
        """After a run that keeps no carry (a fused kernel's): keep the step
        count and drop any earlier carry, so that nothing stale can be
        checkpointed."""
        self.__dict__.pop("_final_carry", None)
        self._steps_done = steps_done

    # -- incremental driving --------------------------------------------------
    def chain(self, n_warmup: int = 0) -> BatchChain:
        """An incremental view of this sampler (:class:`BatchChain`).
        Adaptive samplers prepare their warmup for the first ``n_warmup``
        steps: ``chain(K)`` then ``step(K); step(N)`` visits exactly the
        states of ``run(N, K)``."""
        self._prepare_run(0, n_warmup)
        return BatchChain(self, self._init_carry())

    # -- running ------------------------------------------------------------
    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1):
        """Run ``n_discard + n_collect·thin`` steps and return every
        ``thin``-th collected post-step state as ``[n_chains, n_collect,
        dim]``: a view of the steps-major store (``.transpose(0, 1)`` gives
        the store back without a copy)."""
        self._prepare_run(n_collect, n_discard)
        out = run_kernel(self._step_fn, self._init_carry(), n_collect, n_discard,
                         thin=thin)
        self._keep(out.carry, n_discard + n_collect * thin)
        return out.samples.transpose(0, 1)

    # -- checkpoint / resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write the state after the last run to ``path``: the carry, the
        absolute step count, the stream key the carry was drawn under, the
        chain count and, for a shard, its first global chain and coordinate
        (:func:`..utils.checkpoint.save_carry`).  After ``run_sharded`` each
        rank writes its block."""
        from ..utils.checkpoint import save_carry

        if not hasattr(self, "_final_carry"):
            raise RuntimeError("nothing to checkpoint: call run() first")
        state = {"carry": self._final_carry, "steps": int(self._steps_done),
                 "seed": int(self._carry_key), "n_chains": int(self.n_chains)}
        if self.shard is not None:
            state.update(chain0=self._chain0, col0=self._word0)
        save_carry(state, path)

    def _load_checkpoint(self, path: str):
        """``(carry, steps, key)`` of a checkpoint, its tensors on this
        sampler's device; raises if its chain count, or its block's first
        chain and coordinate, are not this sampler's."""
        from ..utils.checkpoint import load_carry

        state = load_carry(path, device=self.device)
        if int(state["n_chains"]) != self.n_chains:
            raise ValueError(f"checkpoint holds {state['n_chains']} chains, this sampler "
                             f"{self.n_chains}")
        block = (int(state.get("chain0", 0)), int(state.get("col0", 0)))
        if block != (self._chain0, self._word0):
            raise ValueError(f"checkpoint holds the block from chain {block[0]} and "
                             f"coordinate {block[1]}, this sampler the block from "
                             f"{self._chain0} and {self._word0}")
        return state["carry"], int(state["steps"]), int(state["seed"])

    def resume(self, path: str, n_collect: int):
        """Continue a checkpoint for ``n_collect`` more post-step states: no
        burn-in, step indices continuing from the checkpoint's step count,
        and the draws under the checkpoint's stream key, whatever this
        sampler's seed (as in JAX, whose keys ride in the carry).  Adaptive
        samplers keep their adapted state frozen, as after their warmup.
        The checkpoint loads onto this sampler's device, whatever device
        wrote it.  Returns ``[n_chains, n_collect, dim]``."""
        return self._resume(path, n_collect, self._collection_fn)

    def _resume(self, path: str, n_collect: int, collection_fn: Callable):
        carry, offset, key = self._load_checkpoint(path)
        self._prepare_run(n_collect, 0)
        with self._drawing_under(key):
            out = run_kernel(collection_fn(carry), carry, n_collect, 0, step_offset=offset)
            self._keep(out.carry, offset + n_collect)
        return out.samples.transpose(0, 1)

    # Above this many staged bytes (total steps × chains × dim × 4) "auto"
    # picks the stream mode, as in the JAX package.
    _AUTO_STREAM_BYTES = 64 * 1024 * 1024

    def run_progress(self, n_collect: int, n_discard: int = 0, progress: bool = True,
                     mode: str = "auto"):
        """:meth:`run` (no thinning) with a live progress display and
        streaming R-hat.  Returns ``(samples, RunStats)``.

        ``mode="chunked"`` hands each block of 64 post-step states to a
        :class:`..diagnostics.stats.MultiChainTracker`
        (:func:`..core.run_kernel_progress`); ``mode="stream"`` keeps the
        tracker on the device and reads back a few scalars every 64 steps
        (:func:`..core.run_kernel_progress_stream`).  ``"auto"`` picks
        ``"stream"`` once the run would stage more than 64 MiB of states,
        else ``"chunked"``.  In both, the samples stay on the device."""
        self._prepare_run(n_collect, n_discard)
        carry = self._init_carry()
        dim = self._step_fn.extract(carry).shape[-1]
        total = n_discard + n_collect
        if mode == "auto":
            staged = total * self.n_chains * dim * 4
            mode = "stream" if staged > self._AUTO_STREAM_BYTES else "chunked"
        renderer = ProgressRenderer(self.n_chains, total) if progress else None

        if mode == "stream":
            stats = _LatestStats()

            def hook(done, max_rhat, p_accept, window_start, p_chain_window):
                stats.p_accept = float(p_accept)
                stats.p_accept_chain = p_chain_window
                stats.p_accept_chain_start = int(window_start)
                stats._max_rhat = float(max_rhat)
                if renderer is not None:
                    renderer.update(int(done), stats)

            out = run_kernel_progress_stream(self._step_fn, carry, n_collect, n_discard,
                                             hook, collection_fn=self._collection_fn)
        elif mode == "chunked":
            tracker = MultiChainTracker(self.n_chains, dim)

            def callback(done, states):
                tracker.step_batch(states)
                if renderer is not None:
                    renderer.update(done, tracker)

            out = run_kernel_progress(self._step_fn, carry, n_collect, n_discard, callback,
                                      collection_fn=self._collection_fn)
        else:
            raise ValueError(f"unknown progress mode {mode!r}")
        if renderer is not None:
            renderer.close()
        self._keep(out.carry, total)
        samples = out.samples.transpose(0, 1)
        return samples, RunStats.from_sample(samples)
