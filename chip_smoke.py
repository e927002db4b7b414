#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``general_mcmc_torch``) once on one NVIDIA
GPU and hold every hand-written kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. environment: the card (``nvidia-smi``), torch and CUDA versions, the
   first-use ``nvcc`` build of ``general_mcmc_torch/csrc/*.cu``, and the
   registers and spills of every build ("K3-build": each of K3's);
2. K2, the counter-based generator: the fill kernel's bits, uniforms, MH
   draws and paired normals equal the plain version's exactly, the device
   Philox equals the CUDA toolkit's ``curand_Philox4x32_10``, and the device
   Box-Muller pair and log of the uniform (``logf``, ``sqrtf``,
   ``sincosf``), and their branch-free forms that the MH kernel draws with,
   equal the plain ones (``torch.log``, ``sqrt``, ``cos``, ``sin``) bit for
   bit on every one of the 2^24 uniforms; the fill kernel's device time over
   back-to-back launches;
3. K1, the fused HMC kernel, against its plain version at a small size
   (identity and diagonal mass; widths 2, 7, 8, 33, 70, 100 and 512, which
   take every quads-per-lane build and both ways of drawing the accept
   uniform);
4. the slice's main path at full width: ``HMC(..., backend="cuda").run``
   on the 100-d benchmark Gaussian with 10,240 chains, then split-R-hat,
   ESS and the moment audit on the card; the same run through the plain
   version is compared with it and timed;
5. the identity-mass path at full width (a short run); "K1-split", the
   kernel's time at 1, 10 and 20 leapfrogs with 1 and 1,000 stored rows,
   fitted to a step's fixed cost, a leapfrog's and a row's; "K1-maps", the
   main path's run at widths 33, 70 and 100 under every lane map the kernel
   takes at each width, each equal to the others bit for bit, and timed;
6. K3, the fused MH kernel, against its plain version at a small size (every
   device target with every device proposal, widths 1, 2, 7, 8, 33, 70 and
   512: every lane map from a thread a chain to five blocks a lane, at 256
   chains and at a ragged 200), the pCN identity and the thinning identity;
7. the MH main path at full size: ``MetropolisHastings(..., backend="cuda")
   .run`` on the 2-d Gaussian with 16,384 chains of 5,000 collected steps
   (81.9M samples in one launch), the moment, R-hat and ESS checks on the
   card, timed apart; the same run through the plain version is compared
   with it and timed; "K3-chains", the kernel at 4,096, 16,384 and 65,536
   chains of 5,500 steps (samples/s at each); "K3-widths", the kernel on
   the wider maps (a 100-d and a 512-d GaussianND), timed;
8. K4, the fused logistic gradient chain (tensor cores, three TF32 passes),
   against its plain version at small ragged sizes and after 1, 8, 64 and
   512 steps at 10,240 chains, 48 features and 256 observations, and timed,
   with the two ``torch.matmul`` of a step timed alone as a yardstick;
9. ChEES-HMC ("chees-small"): the 2-d autograd target through the adaptive
   law with thinning and a 10-d Gaussian through the static law, 1,024
   chains each, checked against the target's moments; then the headline's
   shape for 8 + 8 steps twice, once drawing from K2's fill kernel and once
   from the plain draws computed on the card and injected, equal bit for
   bit; "chees-main", the bench headline at full size (100-d Gaussian,
   10,240 chains, 192 warmup and 3,072 static steps through
   ``ChEESHMC.run``): R-hat, the moment audit, the fill kernel's launches,
   min-ESS/s, the wall split, peak memory, the device's busy share of a
   10-step collection window from ``torch.profiler``, and the fill kernel
   timed at its ChEES shapes; "chees-logistic", the bench stretch line
   (non-centred hierarchical logistic on bench.py's data, 10,240 chains,
   256 + 1,024 steps with the in-run statistics): R-hat, min-ESS/s and the
   post-warmup divergences;
10. NUTS ("nuts-small", 1,024 chains): the 2-d autograd target with the
    diagonal and with the dense metric and with the multinomial proposal,
    each checked against the target's moments, Neal's funnel (the
    divergence counter) and a 4-d Rosenbrock smoke run; then the headline's
    shape for a 30-step warmup with two window ends and their step-size
    re-searches and 8 collection steps, twice, once drawing from K2's fill
    kernel and once from the plain draws computed on the card and injected,
    equal bit for bit; "nuts-main", the bench's NUTS leg through the
    dynamic tree (100-d Gaussian, 10,240 chains, diagonal metric,
    multinomial proposal, cap 4, 192 warmup and 1,024 collection steps
    through ``NUTS.run``, once; "nuts-static" runs the leg's 3,072): R-hat,
    the moment audit, min-ESS/s, grad-evals/s, the mean tree depth and
    leapfrogs a step, divergences, the wall split, peak memory, the fill
    kernel's launches, the busy share of a 10-step collection window, and
    the fill kernel timed at NUTS's shapes;
11. NUTS through the static window ("nuts-static-small", 1,024 chains): the
    2-d autograd target with the diagonal metric and the slice proposal and
    with the dense metric and the multinomial proposal, against its
    moments, and the funnel (divergences); the headline's shape for 30 + 8
    steps through ``backend="static"``, once with the fill kernel's draws
    and once with the plain ``static_draws`` computed on the card and
    injected, equal bit for bit; an ``"auto"`` run of the headline target
    at 1,024 chains, which must pick ``"static"``; "nuts-static", the
    bench's NUTS leg at full size as ``bench.py`` runs it
    (``backend="static"``), with the gates and fields of "nuts-main" and 15
    leapfrogs a step.

12. the sampler runtime ("runtime-small", 256 chains of the 2-d target):
    for HMC, MH (float and integer states), ChEES (adaptive and static) and
    NUTS (``"torch"``, ``"static"``, ``"auto"``), checkpoint and resume,
    ``chain``, ``track`` and both ``run_progress`` modes equal ``run`` bit
    for bit, a resumed stream follows the checkpoint's seed, a fused run
    leaves nothing to checkpoint; "resume-main", the ChEES headline
    checkpointed half way and resumed on a fresh sampler, equal to
    "chees-main"'s store bit for bit; "progress-main", the headline through
    ``run_progress`` in the stream mode, equal to it bit for bit, with its
    ticks, wall and the tracker's device operations a step; "rank-main",
    the rank-normalized R-hat and bulk and tail ESS of that store on the
    card, checked against the classic ESS and against the CPU in float64 on
    a 64-chain slice; "nuts-resume", the NUTS leg's sampler with
    ``backend="auto"`` checkpointed and resumed, equal to its uninterrupted
    run bit for bit, through the static tree both times;
13. MALA, Gibbs and replica exchange, every draw a launch of K2's fill
    kernel: "mala-small", "gibbs-small" and "tempering-small" at 256 chains
    (each run equal to the same steps with the plain draws injected, bit
    for bit; the moments of tests/test_mala.py; the constant and copy
    conditionals; the swap acceptance of each rung pair); "mala-main" (the
    100-d unit Gaussian at 10,240 chains, 1,000 + 2,000 steps: R-hat, the
    moments, the accept rate, min-ESS/s, a 10-step window), "io-main" (a
    1,024 × 100 × 100 slice of its store to CSV through the native writer,
    a smaller one read back exactly, Arrow and Parquet or their
    ``ImportError`` without pyarrow), "gibbs-main" (the 64-d chain graph at
    10,240 chains: the stationary variance and correlation, R-hat),
    "gibbs-mixture" (the reference's mixture: x's moments) and
    "tempering-main" (the two wells at 10,240 chains from one well: both
    wells' mass and widths, and random-walk MH trapped as the control);
    "runtime-small" also holds MALA, Gibbs and replica exchange to the
    runtime's equalities.

14. ``parallel/`` (chains split over ranks, ``run_sharded``): the ranks are
    child processes of this script sharing the card under a gloo group on
    CUDA tensors (this process joins no group); "shard-small" (K2's fill
    kernel from a nonzero ``chain0``/``word0`` equal to the plain version's
    block and timed; two ranks at 1,024 chains: HMC, MH, MALA, replica
    exchange, Gibbs and NUTS (both trees), each rank's rows bit-equal to the
    unsharded run's; ``init_positions_on_mesh`` the same array on 1 and 2
    ranks), "shard-main" (the ChEES headline on two ranks, 5,120 chains
    each: max pooled R-hat < 1.01, the pooled moment audit < 0.05, ``L``,
    ε̄ and T against chees-main's, each rank's fill launches, wall split and
    the all-reduces of a warmup step with their host time), "shard-one" (the
    headline on a one-rank NCCL mesh, its store bit-equal to chees-main's
    by digest) and "shard-dim" (NUTS and ChEES on a 2 x 2 mesh of four
    ranks with ``shard_dim``, 1,024 chains of a 64-d diagonal Gaussian in
    float64, within 1e-8 of the unsharded runs).

15. The examples and the last repairs: "shard-cuda" (``HMC(backend=
    "cuda")`` at "main"'s shape and ``MetropolisHastings(backend="cuda")``
    at "mh-main"'s through ``run_sharded`` on two gloo ranks: each rank one
    kernel launch, its rows drawn from its ``chain0`` and bit-equal to the
    same rows of the unsharded launch), "shard-dim-odd" (NUTS with the
    diagonal metric and ChEES on the 100-d headline target on a 1 x 4 mesh,
    blocks of 25 from columns 0, 25, 50 and 75, 1,024 chains in float64,
    within 1e-8 of the unsharded runs), "examples" (every program of
    ``examples_torch/`` but the sharded one, its ``main()`` on the card one
    by one with the gates of ``tests/test_examples.py``, its wall and fill
    launches) and "examples-sharded" (``examples_torch/sharded_nuts.py`` as
    one NCCL rank).  "chees-logistic" runs on bench.py's own data, the JAX
    package's ``make_logistic_data(PRNGKey(1), 256, 48)`` shipped as
    ``general_mcmc_torch/data/bench_logistic_k1.npz``.

16. The fused kernels on the repo's other continuous targets (after
    "K3-widths"): "K1-targets" (K1 against its plain version on
    DiffableGaussian2D, Gaussian2D, Rosenbrock2D, RosenbrockND and
    NealsFunnel at every lane map, 256 and 200 chains; each family timed
    beside its plain version; the DiffableGaussian2D through
    ``HMC(backend="cuda")`` at 10,240 chains held to the MH leg's moment
    gates, the 3-d Rosenbrock as examples_torch/rosenbrock3d_hmc.py runs it),
    "K3-targets" (the same for K3, bit for bit, the DiffableGaussian2D at the
    MH main path's shape), "dense-main" (the 100-d dense GaussianND ``D R D``
    through K1 and K3 at 10,240 chains: the std and lag-1 correlation gates,
    the kernels against their plain versions over 8 and 64 steps and over
    the whole run) and, after "chees-logistic", "K1-logistic"
    (``HMC(backend="cuda")`` on the stretch line's posterior in the metric
    that phase adapts, at ε 0.2 beside its ε̄ rounded down (see LGH_EPS):
    one launch of ``csrc/fused_hmc_logistic.cu``, accept,
    R-hat, the posterior against chees-logistic's, the kernel against its
    plain version after 1, 8 and 64 steps, timed beside its two
    ``torch.matmul`` a leapfrog).

17. The tile HMC kernels, which share ``csrc/tile_hmc.cuh``: "dense-main"
    runs K1 on the dense GaussianND through its own kernel,
    ``csrc/fused_hmc_dense.cu`` (one launch; the gradient's two triangular
    solves blocked with a tile's 16 chains as right-hand sides, the panel
    products on the tensor cores in three TF32 passes), holds it to its
    plain version at widths 2, 7, 33, 100 and 168 and from chain 3,000, and
    times one ``torch.cholesky_solve`` of the residual a leapfrog (K1) and
    one ``torch.linalg.solve_triangular`` a step (K3) as library yardsticks;
    "K1-logistic" runs the logistic kernel on 16-chain tiles with the
    gradient carried across steps; "K4-digests" holds K4's output to the
    digests it had before its tile code was shared.

18. K3's dense tile kernel, ``csrc/fused_mh_dense.cu`` on
    ``csrc/tile_mh.cuh`` (the forward solve of ``csrc/dense_tile.cuh``,
    which K1's dense kernel shares, its panels in float32 on the CUDA cores
    rounded as the lane solve it replaced; producer warps draw the normals
    into a ring in shared memory): "dense-main" runs
    ``MetropolisHastings(backend="cuda")`` on the dense GaussianND through
    it (one launch, none of
    ``csrc/fused_mh.cu``), holds it to its plain version over 64 steps at
    the main shape and at widths 2, 7, 33, 168 and 240 with the random walk
    and pCN, and from chain 3,000, and prints its layout (from
    ``fused_mh_dense_layout``), registers and spills and its bounds.  The
    "examples" phase runs auto_backend_nuts's ``main()`` cut to
    ``n_collect=144, n_warmup=48``.

19. The hierarchical logistic family through both fused kernels (after
    "K1-logistic"): "K3-logistic" and "K3-logistic-centred"
    (``MetropolisHastings(backend="cuda")`` on ``HierarchicalLogisticNC``
    and on ``HierarchicalLogistic``, bench.py's data, 10,240 chains from
    "chees-logistic"'s last draws: one launch of
    ``csrc/fused_mh_logistic.cu`` on ``csrc/tile_mh.cuh``, its product on
    the tensor cores; accept, R-hat and the posterior against
    "chees-logistic"'s on a run thinned by KL_THIN; bit-equal to its plain
    version on every chain whose accept history agrees, with the random
    walk and pCN; its chains off the float64 plain version over seeds 0-3
    against the float32 plain version's own; timed beside one
    ``torch.matmul`` a step) and "K1-logistic-centred" (``HMC(backend=
    "cuda")`` on the centred target, one launch of
    ``csrc/fused_hmc_logistic.cu``: accept, R-hat, the posterior against
    the mapped reference, the relative error over the agreeing chains after
    1, 8 and 64 steps, the chains-off count, timed as "K1-logistic").

20. K1 and K3 past 512 dimensions, on the wide map
    (``csrc/fused_hmc_wide.cu``, ``csrc/fused_mh_wide.cu``: one chain a
    cluster of blocks, what crosses threads through distributed shared
    memory), after "K3-targets": "wide-equal" (both kernels against their
    plain versions bit for bit at 513, 1,000, 4,096 and 10,000 dimensions,
    64 chains of 16 steps, every lane target, K1 with and without a
    diagonal M⁻¹, K3 with the random walk and pCN, and from chain 37),
    "K1-wide" (``HMC(backend="cuda")`` on the headline's Gaussian at 1,000
    and 4,096 dimensions, 10,240 chains: accept, R-hat, the moment audit,
    the plain version bit for bit, timed), "hmc-stress" (the reference's
    10,000-d RosenbrockND stress run, 6 chains x 200 steps x 50 leapfrogs,
    equal to ``backend="torch"`` bit for bit, timed) and "K3-wide"
    (``MetropolisHastings(backend="cuda")`` with the random walk 2.38/√d on
    the same Gaussian at 1,000 and 4,096, 16,384 chains from draws of the
    target: the pooled moments, the accept, the plain version bit for bit,
    timed).

Before the last line it prints the card's name and power limit and one JSON
object with every kernel's launches, error, times and bound; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import hashlib
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

import general_mcmc_torch as gmt
from general_mcmc_torch import _build
from general_mcmc_torch import io as gmt_io
from general_mcmc_torch import parallel as gmt_parallel
from general_mcmc_torch.io import native as io_native
from general_mcmc_torch.models.distributions import rowsum
from general_mcmc_torch.models.regression import bench_logistic_data
from general_mcmc_torch.ops import (counter_rng, fused_hmc, fused_hmc_dense,
                                    fused_hmc_logistic, fused_logistic, fused_mh, fused_mh_dense,
                                    fused_mh_logistic, static_tree, tree)
from general_mcmc_torch.samplers import nuts as nuts_module
from general_mcmc_torch.samplers.gibbs import GibbsDraws
from general_mcmc_torch.utils.checkpoint import load_carry
from general_mcmc_torch.utils.progress import ProgressRenderer

# Published peaks of one H100 SXM at its full 700 W power limit: HBM rate,
# the float32 rate outside the tensor cores and the dense TF32 rate of the
# tensor cores.  For a bound, 32-bit integer work (Philox) is counted at the
# float32 rate, which can only lower the bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# The 67 T/s count a fused multiply-add as two operations on each of an SM's
# 128 float32 lanes.  A kernel held bit-equal to separate PyTorch ops executes
# unfused operations, one a lane a clock, and an SM has 64 lanes for 32-bit
# integer work: unfused_ms() states the time of the same operation count
# under those two rates, at the card's highest SM clock as nvidia-smi reports
# it (clocks.max.sm).
F32_LANES_PER_SM, I32_LANES_PER_SM = 128, 64

# Philox4x32-10: 10 rounds of 2 mul-hi, 2 mul-lo and 4 xor, and 9 key bumps
# of 2 adds, for four 32-bit words.
PHILOX_OPS = 10 * 8 + 9 * 2

# The slice's main path: the benchmark target at its full width.
N_CHAINS, DIM = 10_240, 100
N_COLLECT, N_DISCARD = 1000, 200
# step_size: 0.25 accepted 0.96 of proposals in a CPU run of the plain
# version (1024 chains, 50 steps), 0.4 about 0.87 (0.875 on the card).
STEP_SIZE, N_LEAPFROG = 0.4, 10
SEED = 0
# Widths at which "K1-maps" times every lane map: 9, 18 and 25 quads.
K1_MAP_WIDTHS = (33, 70, DIM)

# The MH main path: the 2-d Gaussian stress run (80M samples) spread over
# the card; "K3-chains" runs it at other chain counts.
MH_CHAINS, MH_COLLECT, MH_DISCARD = 16_384, 5000, 500
MH_CHAIN_COUNTS = (4096, MH_CHAINS, 65_536)
# "K3-widths": the wider maps at these chains
MH_WIDTHS, MH_WIDTH_CHAINS = (100, 512), 16_384
# Gaussian2D: 2 subtractions, 9 products and sums, the product with 1/det, a
# scale; random walk: a product and a sum per coordinate
MH_TARGET_OPS, MH_PROPOSAL_OPS = 13, 2
# Back-to-back launches of the fill kernel between two events.
FILL_REPS = 200
MH_MEAN, MH_COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
MH_SCALE = 1.0
MH_MEAN_ATOL, MH_COV_ATOL = 0.05, 0.1

# The logistic gradient chain at the probe's shape.
LG_CHAINS, LG_FEATURES, LG_OBS, LG_STEPS, LG_LR = 10_240, 48, 256, 512, 1e-3
# K4 against its plain version, as max |got - want| / max |want|.  The
# kernel sums its products in another order than torch.matmul, so after one
# step the two differ by the rounding of one gradient (the gate).  Up to 64
# steps that difference does not grow.  By 512 steps the ascent, at this
# step size, has become sensitive to rounding: the plain version in float32
# is then more than 1e-3 away from itself in float64 (a test in
# tests/test_torch_fused_logistic.py shows it), so there the limit holds
# only against a gross fault.
LG_RTOL = {1: 1e-5, 8: 1e-5, 64: 1e-5, 512: 0.1}

# ChEES-HMC.  "chees-small": 1,024 chains; the 2-d target for 48 warmup and
# 24 collected steps at thin 2, the 10-d one for 64 + 32; the K2 check at
# the headline's shape for 8 + 8 steps.
CHEES_SMALL_CHAINS = 1024
CHEES_2D_STEPS, CHEES_10D_STEPS, CHEES_K2_STEPS = (48, 24), (64, 32), (8, 8)
# Moment envelopes of tests/test_chees.py: the 2-d target's mean within 0.3
# and covariance within 0.6 (:52-58); the 10-d target's std/scale within
# 0.15 (:238-250), its mean within 0.3.
CHEES_MEAN_ATOL, CHEES_COV_ATOL, CHEES_STD_RTOL = 0.3, 0.6, 0.15
# "chees-main": the bench headline (bench.py:182-217, :77-102).
CHEES_WARMUP, CHEES_COLLECT = 192, 3072
CHEES_ACCEPT, CHEES_JITTER, CHEES_L = 0.98, 0.5, 10
# "progress-main": the collections it takes in turns with and without the
# stream tracker (a third of the headline's: the ratio is per step)
PROGRESS_TURN_STEPS = 1024
# Collection steps under the profiler.  Its post-processing takes about
# 0.5 s a 1,000 device operations on an H100 host, so the window is short:
# ten steps of the NUTS leg are ~11,000.
CHEES_WINDOW = 10
# "chees-logistic": the bench stretch line (bench.py:737-760).
LGC_DIM, LGC_OBS, LGC_WARMUP, LGC_COLLECT = 50, 256, 256, 1024
LGC_ACCEPT, LGC_JITTER = 0.95, 1.0

# NUTS.  "nuts-small": 1,024 chains; the 2-d target for 200 warmup and 50
# collected steps at cap 6 (the Stan windows end at steps 100, 125 and 149,
# counted from 1),
# the funnel for 20 steps at the fixed step size 1.2 and cap 6
# (tests/test_nuts.py:255-265 runs 150; its gate, a divergence, needs
# fewer), the 4-d Rosenbrock for 15 + 15 (a smoke run: finite draws); the K2
# check at the headline's shape with the windows cut to a 30-step warmup
# (window ends at step indices 19 and 23) and 8 collection steps.
NUTS_SMALL_CHAINS = 1024
NUTS_2D_STEPS, NUTS_2D_DEPTH = (200, 50), 6
NUTS_FUNNEL_STEPS, NUTS_FUNNEL_EPS, NUTS_ROSEN_STEPS = 20, 1.2, (15, 15)
NUTS_K2_STEPS = (30, 8)
NUTS_SHORT_WINDOWS = dict(start_buffer=10, end_buffer=5, initial_window=10)
# The 2-d target's pooled mean within 0.1 and covariance within 0.3 (51,200
# draws; tests/test_nuts.py allows 0.3 and 0.7 at 4,000)
NUTS_MEAN_ATOL, NUTS_COV_ATOL = 0.1, 0.3
# "nuts-main": the bench's NUTS leg (bench.py:103-118, 218-232); "nuts-static"
# runs it at full size as bench.py does, "nuts-main" (the dynamic tree, with
# a read-back a doubling: host-bound) collects NUTS_MAIN_COLLECT steps under
# the same gates
NUTS_WARMUP, NUTS_COLLECT, NUTS_ACCEPT, NUTS_DEPTH = 192, 3072, 0.90, 4
NUTS_MAIN_COLLECT = 1024
# "nuts-static-small": the 2-d target and the funnel at the leg's cap, the
# "auto" run of the headline target for 192 warmup and 64 collection steps
NUTS_STATIC_AUTO_STEPS = (192, 64)

# The sampler runtime.  "runtime-small": 256 chains of the 2-d target (a
# Poisson count for integer MH), RT_WARMUP warmup steps (NUTS's short
# windows end at steps 19 and 25 of them), RT_COLLECT collected,
# checkpointed after RT_SPLIT of them.  "resume-main": the ChEES
# headline checkpointed half way through its collection.  "nuts-resume": the
# NUTS leg's sampler with backend="auto", NUTS_RESUME_COLLECT collected steps
# (a twelfth of nuts-static's), checkpointed half way.
RT_CHAINS, RT_WARMUP, RT_COLLECT, RT_SPLIT = 256, 32, 24, 9
NUTS_RESUME_COLLECT = 256
# "rank-main": the card's rank diagnostics on RANK_SLICE_CHAINS chains against
# the same function on the CPU in float64, and the rank bulk ESS against the
# classic min ESS of the same store
RANK_SLICE_CHAINS, RANK_RTOL, RANK_ESS_RATIO = 64, 1e-4, (0.8, 1.25)

# MALA, Gibbs and replica exchange.  The small phases ("mala-small",
# "gibbs-small", "tempering-small") run 256 chains; the main ones the
# headline's 10,240.  "mala-main": the 100-d unit Gaussian at ε 0.6 (about
# 0.79 accepted: MALA's Gaussian scaling at ℓ = 0.6·100^(1/6)); unit scales
# because MALA has no metric.  2,000 collected after 1,000: split R-hat sits
# about (τ − 1)/(2n) above 1 for half-chains of n steps, and at this ε the
# integrated autocorrelation time τ is ~12, so 1,000 collected steps put
# the JAX package's MALA and the port's alike at ~1.013, above the 1.01
# gate whatever the chain count.
NEW_SMALL_CHAINS = 256
MALA_EPS, MALA_STEPS = 0.6, (2000, 1000)
MALA_SMALL_EPS, MALA_SMALL_STEPS = 0.9, (400, 100)
# "gibbs-main": the 64-d chain graph, 500 after 100; "gibbs-mixture": the
# reference's mixture, 5,000 after 2,000.
GIBBS_DIM, GIBBS_STEPS, GIBBS_SMALL_STEPS = 64, (500, 100), (20, 10)
GIBBS_MIX_STEPS = (5000, 2000)
# "tempering-main": the two wells, geometric_temperatures(6, 64), scale 0.5,
# 2,000 after 300, as examples/two_wells_tempering.py runs them.
TEMPER_LADDER, TEMPER_SCALE, TEMPER_STEPS = (6, 64.0), 0.5, (2000, 300)
TEMPER_SMALL_STEPS = (200, 100)
# "io-main": a [IO_CHAINS, IO_OBS, 100] slice of "mala-main"'s store to CSV,
# and a [IO_CHECK_CHAINS, IO_OBS, 100] slice read back.
IO_CHAINS, IO_OBS, IO_CHECK_CHAINS = 1024, 100, 64

# "K1-targets" and "K3-targets": the repo's other continuous targets through
# the fused kernels.  Each kernel against its plain version at the small
# shapes of "K1-small" and "K3-small" (256 and 200 chains, 20 collected after
# 5 at thin 2, every lane map); a run of each target family timed beside its
# plain version on the same inputs (TG_TIMED_STEPS steps); and the gate runs
# through the samplers: the DiffableGaussian2D (tests/test_pallas.py's) at
# the HMC main path's chains (ε 0.25, L 10, run(1000, 200)) and at the MH
# main path's (random walk 1.0, run(5000, 500)), held to the MH leg's moment
# gates; the 3-d Rosenbrock as examples_torch/rosenbrock3d_hmc.py runs it.
# RosenbrockND at d = 100 (1,024 chains, ε 1e-4, L 50: the step size of
# tests/test_benchmarks.py:107-113) and NealsFunnel(10) (1,024 chains: fixed-ε
# HMC is biased in its neck, so no moment gate) are held only to the plain
# version.
TG_SMALL_CHAINS = (256, 200)
TG_TIMED_STEPS = 64
TG_2D_STEPS, TG_2D_EPS, TG_2D_L = (1000, 200), 0.25, 10
ROSEN3_STEPS, ROSEN3_EPS, ROSEN3_L, ROSEN3_CHAINS, ROSEN3_SEED = (1000, 100), 0.01, 50, 6, 42
ROSEN3_COMPARE_STEPS = 100
ROSEN_WIDE_D, ROSEN_WIDE_CHAINS, ROSEN_WIDE_EPS, ROSEN_WIDE_L = 100, 1024, 1e-4, 50
FUNNEL_CHAINS, FUNNEL_EPS, FUNNEL_L, FUNNEL_WALK = 1024, 0.1, 10, 0.3
# "dense-main": GaussianND(zeros(100), D R D), D the headline's scales and
# R_ij = 0.5^|i-j|; K1 at ε 0.3, L 10, M⁻¹ = D², run(1000, 200) from
# init_with_seed; K3 the random walk 0.1, run(2000, 500), from exact draws
# of the target (L times init_with_seed's normals): a walk of 0.1 moves a
# coordinate ~0.1·sqrt(2,500) ≈ 5 in the run, so from standard-normal
# starts the scale-10 coordinates cannot reach their spread whatever the
# kernel; from the target the gates test that the kernel leaves it
# invariant.  Gates: max|std/scale - 1| and the mean lag-1 correlation
# corr(x_i, x_i+1) against 0.5, each within DENSE_TOL; K1 against its plain
# version over DENSE_EQ_STEPS steps, no chain differing; K3 by the logistic
# kernels' rule: over KL_OFF_SEEDS at KL_OFF_STEPS (64) steps, its chains off
# the float64 plain version at most the float32 plain version's own +
# KL_OFF_SLACK (a rule of no chain off the float32 plain version at seed 0
# passed there and failed at seeds 1, 3, 5, 6 and 7: each flip is a uniform
# within float32 rounding of its threshold, which either float32 program may
# take either way).
DENSE_EPS, DENSE_L, DENSE_STEPS = 0.3, 10, (1000, 200)
DENSE_WALK, DENSE_MH_STEPS = 0.1, (2000, 500)
DENSE_TOL = {"K1": 0.05, "K3": 0.1}
DENSE_EQ_STEPS = {"K1": 8, "K3": 64}
# K1's dense tile kernel against its plain version at small widths (one
# build each for 1, 5, 13 and 21 column blocks: odd widths and the widest),
# DENSE_SMALL_CHAINS chains of 8 steps in the main run's metric; and a block
# of rows from chain DENSE_CHAIN0 bit-equal to the launch from 0.  K3's
# dense tile kernel the same at MH_DENSE_SMALL_DIMS (also 30 blocks, the
# widest), DENSE_EQ_STEPS steps from draws of the target, with the random
# walk and with pCN.
DENSE_SMALL_DIMS, DENSE_SMALL_CHAINS, DENSE_CHAIN0 = (2, 7, 33, 168), 256, 3000
MH_DENSE_SMALL_DIMS = (2, 7, 33, 168, 240)
# "K1-logistic": HMC(backend="cuda") on the stretch line's posterior in the
# diagonal metric "chees-logistic" adapts, L 10, from 0.1 x init_with_seed,
# run(1000, 200).  The step size: that phase's ε̄ (0.169134 on the card,
# seeded, the same in every run) rounded down to two figures, 0.16, accepts
# more than 0.95 of proposals at L 10 - ChEES adapts towards a 0.95 target -
# so it misses the gate's window; LGH_EPS meets it.  The phase runs the
# rounded ε̄ too, for LGH_ROUNDED_STEPS, and prints its accept rate.
# Against its plain version at 1, 8 and 64 steps as max|Δ|/max|θ| over the
# chains whose accept decisions agree (K4's criterion for the same
# products), the chains whose accept histories differ reported; the
# posterior's mean within LGH_MEAN_SD of chees-logistic's sd, its sd within
# LGH_SD_REL.
LGH_L, LGH_STEPS, LGH_EQ_STEPS, LGH_RTOL = 10, (1000, 200), (1, 8, 64), 1e-5
LGH_EPS, LGH_ROUNDED_STEPS = 0.2, (300, 100)
LGH_MEAN_SD, LGH_SD_REL = 0.1, 0.1
# "K3-logistic" and "K3-logistic-centred": MetropolisHastings(backend="cuda")
# on the stretch line's posterior, each parameterisation, from
# "chees-logistic"'s last draws (in the posterior), the random walk
# 2.38/sqrt(50) x the least posterior sd rounded down to two figures:
# run(2000, 500), one launch, its accept in KL_ACCEPT, timed.  The walk at
# that scale mixes slowly along the wider coordinates, an integrated
# autocorrelation time of thousands of steps: that run's split-R-hat is far
# above 1.01 (the phase prints it, unthinned_max_rhat).  So the R-hat and
# moment gates read a run thinned by KL_THIN (800,500 steps), which puts
# 400,000 steps in each half-chain.  The kernel against its
# plain version: bit-equal on every chain whose accept history agrees,
# after KL_EQ_STEPS steps, the random walk at the full shape and pCN
# (KL_PCN) at KL_PCN_CHAINS; and over KL_OFF_SEEDS at 64 steps, its chains
# off the float64 plain version at most the float32 plain version's own
# count + KL_OFF_SLACK (0.1% of the chains).  Moments: LGH_MEAN_SD and
# LGH_SD_REL against "chees-logistic"'s (the centred target: its draws
# mapped to (mu, log tau, beta)).
KL_STEPS, KL_THIN, KL_ACCEPT = (2000, 500), 400, (0.1, 0.6)
KL_EQ_STEPS, KL_PCN, KL_PCN_CHAINS = (1, 8, 64), 0.5, 1024
KL_OFF_SEEDS, KL_OFF_STEPS, KL_OFF_SLACK = (0, 1, 2, 3), 64, 10
# "K1-logistic-centred": HMC(backend="cuda") on the centred target in the
# metric of "chees-logistic"'s mapped draws (their variance), L 10, from
# 0.1 x init_with_seed, run(1000, 200), at LGHC_EPS, where the accept rate
# lies in 0.6-0.95 (the phase's gate).  At ε 0.3 the leapfrog crosses the
# funnel's neck near its stability limit in the first 64 steps, and the
# float32 plain version itself drifts 1.5e-5 from its float64 run there
# (the kernel 8.0e-5 from the float32 plain version, 5.4 times that drift;
# the non-centred kernel 6.6 times it): the agreement rule (LGH_RTOL)
# cannot tell rounding from a fault at that step.  At 0.25 the two drifts
# are 6.3e-7 and 1.4e-6 (port_scripts/k1_centred_drift.py, on an H100).
# beta held to the mapped reference at LGH_MEAN_SD and LGH_SD_REL; mu and
# log tau at LGHC_HYPER (a fixed-ε HMC on the centred funnel
# under-explores small tau, and the plain version shares that).
LGHC_EPS, LGHC_HYPER = 0.25, (0.25, 0.25)

# "logistic-german": German credit numeric's shape (Inference Gym's
# GermanCreditNumericLogisticRegression, the ChEES paper's logistic target),
# 1,000 observations x 24 features, on synthetic data of that shape from the
# port's make_logistic_data at LGG_SEED (the real file is not in the
# repository): X's hi and lo do not fit in a block's shared memory, so both
# kernels stream it.  ChEES (plain PyTorch, "chees-logistic"'s settings) for
# LGG_WARMUP + LGG_COLLECT steps gives the posterior, an adapted metric and
# its step size (256 warmup steps left its R-hat at 1.039); HMC(backend=
# "cuda") on both targets in that metric (the centred one in the mapped
# draws' variance), L 10, run(1000, 200) from ChEES's last draws, at the
# largest factor of ChEES's ε̄ among LGG_EPS_FACTORS whose accept over a
# pilot run(LGG_PILOT) stays at least LGG_ACCEPT_FLOOR (ChEES adapts towards
# 0.95, past the gate's window; near the leapfrog's stability edge, 2.5 ε̄
# on the non-centred target, the trajectories amplify float32 rounding
# past the agreement gate); MH on both targets from ChEES's last draws, the
# random walk 2.38/sqrt(26) x the least posterior sd rounded down to two
# figures, run(2000, 500) timed.  The references are the moments of
# ChEES's last draws (10,240 posterior draws; its pooled collection carries
# a few wide excursions in log tau that inflate the mapped betas' spread,
# PERF.md §7: the phase prints where they lie, draws past LGG_FAR sds of
# the last draws').  R-hat and moments come from thinned runs: HMC's from
# run(1000, 200, thin=LGG_HMC_THIN) (unthinned, mu's autocorrelation at L 10
# leaves R-hat at 1.018-1.036 on the non-centred target,
# port_scripts/logistic_german_scan.py), MH's from run(2000, 500, thin=T) at
# KG_GATE[target] = (chains, T) within 30 s of card time (the walk's
# autocorrelation there runs to thousands of steps on the non-centred
# target: R-hat - 1 falls as 1 / steps, 0.0147 thinned by 250, 0.0095
# by 390 and 0.0092 by 400; a step takes ~30 µs at one or two tiles a block
# (2,048 or 2,560 chains: 29.8 s thinned by 400, 29.7-30.2 s by 390 at
# 2,560, and ~47 µs at five), so 2,048 chains thinned by 390, ~29 s).  The
# gates are "K1-logistic"'s, "K3-logistic"'s and "K1-logistic-centred"'s.
LGG_OBS, LGG_FEATURES, LGG_SEED = 1000, 24, 7
LGG_WARMUP, LGG_COLLECT = 512, 512
LGG_EPS_FACTORS = (1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0)
LGG_PILOT, LGG_ACCEPT_FLOOR, LGG_HMC_THIN = (50, 50), 0.88, 4
KG_GATE, KG_GATE_MS = {"nc": (2048, 390), "centred": (10_240, 60)}, 30_000
LGG_FAR = 6.0
# "logistic-wide": both kernels against their plain versions at LGW_CHAINS
# chains and LGW_STEPS steps, at each (n_obs, p) of LGW_CASES (just past the
# old limit; long; wide; wider; the widest taken; and the stretch line's
# 256 x 48, resident), both targets, data from make_logistic_data at
# LGW_SEED and positions at the posterior's scale (z or beta ~ N(0, 1/p),
# log tau -1): K3 with the random walk LGW_WALK / sqrt(n_obs p), bit-equal
# on the chains whose accept histories agree; K1 at ε LGW_EPS, L 5, in the
# metric M⁻¹ = 1 / n_obs, from those positions after LGW_BURN steps of
# its own (in the posterior: from the start's transient, whose gradients
# are O(n_obs), 10,000 observations' float32 sums differ by more), within
# LGH_RTOL there; and each kernel's chains off the float64 plain version by
# the logistic family's rule (chains_off: a K3 position depends on the
# density only through the accept decisions, so the bit check alone holds
# for any density).  At 256 x 48 the resident
# path's K3 store and K1 store of the non-centred target have the parent
# commit's digests (RESIDENT_DIGESTS, sha256 of the float32 bytes).
LGW_CASES = ((800, 24), (10_000, 24), (4096, 48), (1024, 100), (1024, 256), (256, 48))
LGW_CHAINS, LGW_STEPS, LGW_SEED, LGW_WALK, LGW_EPS, LGW_BURN = 512, 64, 3, 0.5, 0.25, 200
RESIDENT_DIGESTS = {"K3": "28b8572d7fd30bd4a98702555668bbf38db7abcf66ec4fa9585183a95a43103d",
                    "K1": "039709d11d7e752e8b4bca04757b9767a91f338d39567b0f0cce996bcd71c06e"}

# The wide map (csrc/fused_hmc_wide.cu, csrc/fused_mh_wide.cu: one chain a
# cluster of blocks past a warp's 512 dimensions).  "wide-equal": both
# kernels against their plain versions bit for bit at WIDE_EQ_WIDTHS,
# WIDE_EQ_CHAINS chains of WIDE_EQ_STEPS steps (K1 at L WIDE_EQ_L, with and
# without a diagonal M⁻¹; K3 with the random walk and pCN) on every lane
# target, and from chain WIDE_CHAIN0 (the cases of tests/torch_wide_cases.py,
# which tests/test_torch_cuda_wide.py runs too).  "K1-wide": HMC(backend="cuda")
# on GaussianND(zeros(d), exp(linspace(0, log 10, d))) in the metric M⁻¹ =
# scales², L 10, from init_with_seed(N_CHAINS, d, SEED), K1_WIDE_RUNS[d] =
# (ε, n_collect, n_discard, thin); the ε of my CPU runs of the plain
# version at 256 chains (d = 1,000: 0.2 accepted 0.865; d = 4,096: 0.11
# accepted 0.931, 0.115 0.851, while 0.158, the main path's 0.4 scaled by
# (100 / d)^(1/4), left the chains at their start, where the energy error's
# first-order term does not cancel); the accept over an unthinned
# run(WIDE_ACCEPT_STEPS, n_discard); the plain version over the whole run at
# d = 1,000 and over K1_WIDE_PLAIN_STEPS at 4,096, bit for bit.  "hmc-stress":
# the reference's stress case (tests/test_benchmarks.py:107-113), RosenbrockND
# at STRESS_DIM from 0.1 x init_with_seed(STRESS_CHAINS, STRESS_DIM,
# STRESS_SEED), ε STRESS_EPS, L STRESS_L, run(STRESS_STEPS, 0), equal to
# backend="torch" bit for bit.  "K3-wide": MetropolisHastings(backend="cuda")
# with the random walk 2.38/sqrt(d) on the same Gaussian, K3_WIDE_CHAINS
# chains from exact draws of the target (scales x init_with_seed's
# normals), K3_WIDE_RUN = (n_collect, n_discard, thin): the walk moves a
# scale-10 coordinate ~0.075·sqrt(1,000 x 0.3) ≈ 1.3 in the run, so its
# split-R-hat over 20 thinned draws cannot reach 1.01 whatever the kernel
# (the phase prints it); the gates are the pooled mean and sd against the
# target's (WIDE_MOMENT_TOL of each scale) and the accept over an unthinned
# run(WIDE_ACCEPT_STEPS, n_discard) in K3_WIDE_ACCEPT.
WIDE_EQ_WIDTHS, WIDE_EQ_CHAINS, WIDE_EQ_STEPS, WIDE_EQ_L = (513, 1000, 4096, 10_000), 64, 16, 5
WIDE_CHAIN0 = 37
K1_WIDE_RUNS = {1000: (0.2, 100, 200, 10), 4096: (0.11, 20, 200, 50)}
K1_WIDE_PLAIN_STEPS = (2, 20, 50)  # n_collect, n_discard, thin: 120 steps
WIDE_ACCEPT_STEPS = 10
STRESS_CHAINS, STRESS_DIM, STRESS_SEED = 6, 10_000, 3
STRESS_EPS, STRESS_L, STRESS_STEPS = 1e-4, 50, 200
K3_WIDE_CHAINS, K3_WIDE_RUN, K3_WIDE_ACCEPT = 16_384, (20, 500, 25), (0.2, 0.8)
WIDE_MOMENT_TOL = 0.05

# K1 against its plain version.  Both round every elementwise operation the
# same way (the kernel is built with -fmad=false) and accumulate row sums in
# double, so they differ by the float32 ulps of the libm functions at most;
# a flipped accept decision would show as a chain off by O(1).
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# K3 is built and summed the same way and is held to the same tolerance.


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# The script's start: each phase line ends with the seconds since then.
T0 = time.perf_counter()
# One line at a time: the phases of child processes report from threads.
SAY_LOCK = threading.Lock()


def say(phase: str, **fields) -> None:
    fields["t_s"] = f"{time.perf_counter() - T0:.1f}"
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    with SAY_LOCK:
        sys.stdout.write(f"[{phase}] {body}\n")
        sys.stdout.flush()


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def reset_counts() -> None:
    fused_hmc.launches = 0
    fused_hmc.wide_launches = 0
    fused_mh.wide_launches = 0
    fused_hmc_dense.launches = 0
    fused_hmc_logistic.launches = 0
    counter_rng.launches = 0
    fused_mh.launches = 0
    fused_mh_dense.launches = 0
    fused_mh_logistic.launches = 0
    fused_logistic.launches = 0


def timed(fn, reps: int):
    """Median device time (CUDA events, ms) and median host wall time (s,
    synchronised before and after) of ``reps`` calls of ``fn``; returns
    them with the last result."""
    dev_ms, wall_s, out = [], [], None
    for _ in range(reps):
        out = None
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        dev_ms.append(start.elapsed_time(end))
    return sorted(dev_ms)[reps // 2], sorted(wall_s)[reps // 2], out


def device_ms(fn, reps: int) -> float:
    """Device time in ms of one call of ``fn``: ``reps`` back-to-back calls
    between two events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time in ms for the work, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_matmul_ms(dev, shapes, count: int) -> float:
    """The yardstick of a logistic kernel: the ``torch.matmul`` of ``shapes``
    (pairs of operand shapes, float32, TF32 off) alone, 200 rounds between
    two events, times ``count`` rounds; the port never calls them."""
    ops = [(torch.randn(a, device=dev), torch.randn(b, device=dev)) for a, b in shapes]

    def rounds():
        for _ in range(200):
            for a, b in ops:
                torch.matmul(a, b)

    ms, _, _ = timed(rounds, 3)
    return ms / 200 * count


def unfused_ms(float_ops: float, int_ops: float) -> float:
    """Time in ms of the operations at one unfused float32 operation a lane
    a clock and the integer operations at the SM's 32-bit integer rate, at
    the highest SM clock (see F32_LANES_PER_SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_s = sms * max_sm_clock_hz()
    return (float_ops / F32_LANES_PER_SM + int_ops / I32_LANES_PER_SM) / per_s * 1e3


def fused_hmc_work(n: int, d: int, n_steps: int, n_collect: int, n_leapfrog: int):
    """Bytes, float operations and integer operations of one fused HMC run:
    x0 read and the sample store written once; per element and step a
    quarter of a Philox block (four normals a block), half a Box-Muller
    pair (~10), momentum scale, kinetic energies and log density (~11), the
    gradient at the step's start (2), the select (1), and 7 per leapfrog
    (p += (M⁻¹m)ε: 3, g = −(p−μ)·prec: 2, m += gε: 2)."""
    n_bytes = 4 * n * d * (1 + n_collect) + 4 * 4 * d
    elem_steps = n * d * n_steps
    return (n_bytes, elem_steps * (10 + 11 + 2 + 1 + 7 * n_leapfrog),
            elem_steps * PHILOX_OPS / 4)


def fused_mh_work(n: int, d: int, n_steps: int, n_collect: int, target_ops: int,
                  proposal_ops: int):
    """Bytes and operations of one fused MH run: x0 read and the sample
    store written once; per chain and step the Philox blocks of its word
    sequence (⌈d/2⌉ // 2 + 1: one at d = 2), a Box-Muller pair per two
    coordinates (two uniforms 4, log 4, sqrt 2, the angle 1, sincos 4, two
    products: ~15), the proposal per coordinate, the target, and the accept
    test with its select (uniform 2, log 4, subtract, compare, d + 1
    selects).  Returns bytes, float operations and integer operations."""
    n_bytes = 4 * n * d * (1 + n_collect)
    pairs = (d + 1) // 2
    per_step = 15 * pairs + proposal_ops * d + target_ops + 8 + d + 1
    return n_bytes, n * n_steps * per_step, n * n_steps * PHILOX_OPS * (pairs // 2 + 1)


def fused_mh_work_two_blocks(n: int, d: int, n_steps: int, n_collect: int, target_ops: int,
                             proposal_ops: int):
    """The same count for the two-block layout MH's draws had before the
    one-sequence layout: a Philox block and two cosine-only Box-Muller
    draws (~12 each) per dimension pair, and a block of its own for the
    accept draw."""
    n_bytes = 4 * n * d * (1 + n_collect)
    per_step = (12 + proposal_ops) * d + target_ops + 6 + d + 1
    return (n_bytes, n * n_steps * per_step,
            n * n_steps * PHILOX_OPS * ((d + 1) // 2 + 1))


def fused_logistic_work(n: int, p: int, n_obs: int, n_steps: int):
    """Bytes, product flops and other operations of one fused logistic
    chain: the state read and written once, X and y read once; per chain and
    step the two products (4·n_obs·p), a sigmoid and a subtraction per
    observation (~8), and β, the hyper sums and the update per feature
    (~8)."""
    n_bytes = 4 * (2 * n * (p + 2) + n_obs * p + n_obs)
    return n_bytes, n * n_steps * 4 * n_obs * p, n * n_steps * (8 * n_obs + 8 * p)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm, "1980 MHz")."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def phase_environment():
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    # one nvcc per source (the dense Gaussian's kernels one per width they
    # are run at here, the logistic tile kernels one per count of feature
    # tiles), all started together
    _build.build(["counter_rng", "fused_hmc", "fused_mh", "fused_logistic", "fused_hmc_wide",
                  "fused_mh_wide"]
                 + sorted({logistic_hmc_build(p) for p in LOGISTIC_WIDTHS})
                 + sorted({logistic_mh_build(p) for p in LOGISTIC_WIDTHS})
                 + [dense_build(d) for d in sorted(set(DENSE_SMALL_DIMS + (DIM,)))]
                 + [dense_build(d, "fused_mh_dense")
                    for d in sorted(set(MH_DENSE_SMALL_DIMS + (DIM,)))])
    build_s = time.perf_counter() - t0
    # the full register and spill report, beside the built libraries
    with open(_build.OUT_DIR / "ptxas.log", "w") as f:
        for name, log in sorted(_build.compile_log.items()):
            f.write(f"== {name}\n{log}\n")
    report = {name: ptxas_report(log) for name, log in _build.compile_log.items()}
    regs = [r for funcs in report.values() for r, _ in funcs.values()]
    spilled = {f: b for funcs in report.values() for f, (_, b) in funcs.items() if b}
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=json.dumps(torch.cuda.get_device_name(0)), build_s=f"{build_s:.1f}",
        built=len(_build.compile_log), max_registers=max(regs) if regs else "n/a",
        spill_store_bytes=json.dumps(spilled))
    # K3's builds, one per map and design, target and proposal
    say("K3-build", template="fused_mh_kernel<lanes,blocks_a_lane,tile,target,proposal>, "
        "fused_mh_ws_kernel<producer_warps,tile,target,proposal>",
        registers_and_spill_store_bytes=json.dumps(report.get("fused_mh", {})))
    return smi


def dense_build(d: int, name: str = "fused_hmc_dense") -> str:
    """The build of ``csrc/<name>.cu`` (a dense tile kernel, K1's or K3's)
    that runs width ``d``."""
    return _build.variant(name, GMT_DENSE_NB=-(-d // fused_hmc_dense.BLOCK))


def logistic_mh_build(p: int) -> str:
    """The build of ``csrc/fused_mh_logistic.cu`` (K3's logistic tile
    kernel) that runs ``p`` features."""
    return _build.variant("fused_mh_logistic",
                          GMT_LOGISTIC_PT=fused_mh_logistic.feature_tiles(p))


def logistic_hmc_build(p: int) -> str:
    """The build of ``csrc/fused_hmc_logistic.cu`` (K1's logistic tile
    kernel) that runs ``p`` features."""
    return _build.variant("fused_hmc_logistic",
                          GMT_LOGISTIC_PT=fused_hmc_logistic.feature_tiles(p))


# The feature counts the logistic phases run: one build of each logistic
# tile kernel for each count of feature tiles among them.
LOGISTIC_WIDTHS = sorted({LG_FEATURES, LGG_FEATURES} | {p for _, p in LGW_CASES})


def build_report(key: str, kernel: str) -> dict:
    """Registers and spill store bytes of a build's ``kernel<...>``
    (``ptxas -v``)."""
    regs, spill = ptxas_report(_build.compile_log.get(key, "")).get(kernel, (None, None))
    return dict(registers=regs, spill_store_bytes=spill)


def ptxas_report(log: str) -> dict:
    """``{kernel<template arguments>: (registers, spill store bytes)}`` of one
    library's ``ptxas -v`` output."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
    return out


def kernel_name(mangled: str) -> str:
    """``kernel<template arguments>`` of a mangled ``..._kernel`` entry: the
    name is the identifier ending in ``_kernel`` whose length prefix fits."""
    end = mangled.find("_kernel") + len("_kernel")
    for start in range(end - len("_kernel"), 0, -1):
        n = len(mangled[start:end])
        if mangled[:start].endswith(str(n)):
            name, args = mangled[start:end], re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            if args is None:
                return name
            return name + "<" + ",".join(re.findall(r"(\d+)E", args.group(1))) + ">"
    return mangled


def phase_counter_rng(dev):
    """K2: the fill kernel against the plain bits, and curand."""
    n, words, seed, step = N_CHAINS, 128, 123_456_789, 77
    got = counter_rng.counter_rng_fill(n, words, seed, step, counter_rng.TAG_MOMENTUM,
                                       "bits", device=dev)
    want = counter_rng.counter_rng_fill_reference(n, words, seed, step,
                                                  counter_rng.TAG_MOMENTUM, "bits",
                                                  device=dev)
    check(torch.equal(got, want), "K2 fill bits equal the plain bits")
    errs = {}
    # the mh kind at widths 2 (one block a step), 7 (odd pairs) and 100
    # (even pairs: the uniform opens a block of its own)
    for kind, cols in (("uniform", words), ("normal_pair", words), ("mh", 3), ("mh", 8),
                       ("mh", 101)):
        g = counter_rng.counter_rng_fill(n, cols, seed, step, counter_rng.TAG_PROPOSAL,
                                         kind, device=dev)
        w = counter_rng.counter_rng_fill_reference(n, cols, seed, step,
                                                   counter_rng.TAG_PROPOSAL, kind,
                                                   device=dev)
        name = kind if kind != "mh" else f"mh{cols - 1}"
        errs[name] = float((g - w).abs().max())
        check(torch.equal(g, w), f"K2 {name} draws equal the plain version's ({errs[name]})")
    # curand's Philox4x32-10 on Random123's known-answer inputs and on
    # random (key, counter) pairs
    gen = torch.Generator().manual_seed(5)
    kat_ctr = [[0, 0, 0, 0], [0xFFFFFFFF] * 4, [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]]
    kat_key = [[0, 0], [0xFFFFFFFF] * 2, [0xA4093822, 0x299F31D0]]
    ctr = torch.cat([torch.tensor(kat_ctr, dtype=torch.int64),
                     torch.randint(0, 2**32, (253, 4), generator=gen, dtype=torch.int64)])
    key = torch.cat([torch.tensor(kat_key, dtype=torch.int64),
                     torch.randint(0, 2**32, (253, 2), generator=gen, dtype=torch.int64)])
    as_i32 = lambda t: (t - ((t >> 31) << 32)).to(torch.int32)
    mine, theirs = counter_rng.curand_check(as_i32(key).to(dev), as_i32(ctr).to(dev))
    check(torch.equal(mine, theirs), "device Philox equals curand_Philox4x32_10")
    plain = torch.stack([
        torch.stack(counter_rng.philox4x32_10(*ctr[i], int(key[i, 0]), int(key[i, 1])))
        for i in range(ctr.shape[0])])
    check(torch.equal(mine.cpu(), as_i32(plain)), "device Philox equals the plain Philox")
    kat = [f"{int(w) & 0xFFFFFFFF:08x}" for w in mine[0].cpu()]
    # the device Box-Muller pair and log (logf, sqrtf, sincosf) against the
    # plain ones (torch.log, sqrt, cos, sin on the card) on every 24-bit
    # uniform: the fused HMC kernel (box_muller_pair) and the fused MH kernel
    # (box_muller_pair_straight) equal their plain versions bit for bit only
    # if these do
    differ = {}
    for straight in (False, True):
        z_cos, z_sin, log_u, bits = counter_rng.pair_sweep(dev, straight)
        want_cos, want_sin = counter_rng.box_muller_pair(bits, bits)
        want_log = torch.log(counter_rng.bits_to_uniform(bits))
        differ[straight] = (int((z_cos != want_cos).sum()) + int((z_sin != want_sin).sum())
                            + int((log_u != want_log).sum()))
        check(differ[straight] == 0, f"device Box-Muller pair and log (straight={straight}) "
              f"equal torch's bit for bit ({differ[straight]} of {3 * bits.numel()} differ)")
        del z_cos, z_sin, log_u, bits, want_cos, want_sin, want_log
    pair_diff = differ[False]

    # the fill kernel's device time: FILL_REPS back-to-back launches of the
    # built function between two events, after a warm-up; one wrapper call
    # (its load, argument setup and allocation) is timed beside it
    out = torch.empty((n, words), dtype=torch.int32, device=dev)
    lib, launch = counter_rng.fill_launcher(out, seed, step, 0, "bits")
    codes = []
    ms = device_ms(lambda: codes.append(launch()), FILL_REPS)
    _build.check(lib, next((c for c in codes if c), 0), "counter_rng_fill (timed)")
    check(torch.equal(out, want), "K2 timed fill bits equal the plain bits")
    call_ms, _, _ = timed(lambda: counter_rng.counter_rng_fill(n, words, seed, step, 0, "bits",
                                                               device=dev), 20)
    ref = lambda: counter_rng.counter_rng_fill_reference(n, words, seed, step, 0, "bits",
                                                         device=dev)
    plain_ms, _, _ = timed(ref, 5)
    b_ms, b_by = bound(4 * n * words, n * words / 4 * PHILOX_OPS)
    say("K2", words=f"{n}x{words}", bits_equal=True, curand_equal=True,
        curand_pairs=ctr.shape[0], kat0="".join(kat),
        **{f"max_abs_err_{k}": v for k, v in errs.items()}, pair_sweep_uniforms=1 << 24,
        pair_sweep_differ=pair_diff, straight_sweep_differ=differ[True],
        fill_ms=f"{ms:.5f}", fill_reps=FILL_REPS, wrapper_call_ms=f"{call_ms:.4f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.5f}", bound_share=f"{b_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(errs.values()), wrapper_call_ms=call_ms)


def compare(got, want, what):
    """Max |Δ| of two sample tensors, after checking the tolerance and
    counting the chains that differ beyond it."""
    close = torch.isclose(got, want, rtol=K1_RTOL, atol=K1_ATOL)
    bad_chains = int((~close).reshape(got.shape[0], -1).any(dim=1).sum())
    err = float((got - want).abs().max())
    check(bad_chains == 0, f"{what}: kernel equals plain version within rtol={K1_RTOL}, "
          f"atol={K1_ATOL} ({bad_chains} chains differ, max |d| {err})")
    return err


def phase_small(dev):
    """K1 against its plain version at 256 chains, identity and diagonal
    mass, at widths that take every build and branch of the kernel: 2 (a
    lane a chain, one quad), 7 (odd: scalar stores) and 8 (two quads a lane,
    no idle lane slot: every lane draws the accept block), 33 and 70 (three
    quads a lane), 100 (the main path's map) and 512 (a warp a chain, four
    quads a lane)."""
    errs, maps, moved = [], {}, []
    for d in (2, 7, 8, 33, 70, 100, 512):
        gen = torch.Generator().manual_seed(d)
        mean = torch.randn(d, generator=gen)
        scales = torch.exp(torch.randn(d, generator=gen) * 0.5)
        target = gmt.GaussianND(mean, scales, device=dev)
        x0 = gmt.init_with_seed(256, d, 3, device=dev)
        maps[d] = "x".join(str(v) for v in fused_hmc.lane_map(d))
        for mass_inv in (None, (scales**2).to(dev)):
            # identity mass: the narrowest scale bounds the step size
            eps = 0.3 if mass_inv is not None or d <= 8 else 0.05
            args = (target, x0, eps, 5, 20, 5)
            kw = dict(seed=11, thin=2, mass_inv=mass_inv)
            got = fused_hmc.fused_hmc_run(*args, **kw)
            want = fused_hmc.fused_hmc_run_reference(*args, **kw)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (256, 20, d), "K1 output shape")
            errs.append(compare(got, want, f"K1 d={d} mass={mass_inv is not None}"))
            moved.append(float((got[:, 1:] != got[:, :-1]).any(dim=2).float().mean()))
    check(min(moved) > 0.02, f"K1 small cases accept ({moved})")
    say("K1-small", cases=len(errs), rtol=K1_RTOL, atol=K1_ATOL, max_abs_err=max(errs),
        lane_maps=json.dumps(maps), moved_min=f"{min(moved):.3f}",
        moved_max=f"{max(moved):.3f}")
    return dict(max_abs_err=max(errs))


def hmc_main_sampler(dev):
    """The HMC main path: its target, initial positions, ``mass_inv`` and
    a factory of its sampler (the 100-d benchmark Gaussian, 10,240 chains,
    the diagonal metric, the fused kernel)."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev)
    mass_inv = (scales**2).to(dev)
    return target, x0, mass_inv, lambda: gmt.HMC(target, x0, STEP_SIZE, N_LEAPFROG, seed=SEED,
                                                 mass_inv=mass_inv, backend="cuda")


def phase_main_path(dev):
    """The slice at full width through the user's entry points."""
    target, x0, mass_inv, sampler = hmc_main_sampler(dev)
    scales = target.cov.cpu()  # the standard deviations

    reset_counts()
    samples = sampler().run(N_COLLECT, N_DISCARD)
    store = samples.transpose(0, 1)  # the steps-major [n_collect, n, d] store
    rhat, ess, _mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                    return_moments=True)
    torch.cuda.synchronize()
    counts = dict(fused_hmc=fused_hmc.launches, counter_rng_fill=counter_rng.launches)

    check(counts["fused_hmc"] == 1, f"one fused HMC launch on the main path ({counts})")
    check(tuple(samples.shape) == (N_CHAINS, N_COLLECT, DIM), "sample shape")
    check(bool(torch.isfinite(store).all()), "every sample is finite")
    max_rhat = float(rhat.max())
    min_ess = float(ess.min())
    audit = float((std.cpu() / scales - 1.0).abs().max())
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())
    check(max_rhat < 1.01, f"max R-hat {max_rhat} < 1.01")
    check(audit < 0.05, f"moment audit max|std/scale - 1| {audit} < 0.05")
    check(0.6 < accept < 0.95, f"accept rate {accept} within 0.6-0.95")
    diag_ms, _, _ = timed(lambda: gmt.split_rhat_mean_ess(store, steps_major=True), 1)

    # the same run through the plain version, on the same inputs
    t0 = time.perf_counter()
    plain = fused_hmc.fused_hmc_run_reference(target, x0, STEP_SIZE, N_LEAPFROG, N_COLLECT,
                                              N_DISCARD, seed=SEED, mass_inv=mass_inv)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = compare(samples, plain, "K1 at full width")
    del plain

    # timing: three warm runs of the whole sampling call
    del samples, store
    ms, wall, out = timed(lambda: sampler().run(N_COLLECT, N_DISCARD), 3)
    del out
    n_steps = N_COLLECT + N_DISCARD
    grad_evals = N_CHAINS * n_steps * N_LEAPFROG
    n_bytes, f_ops, i_ops = fused_hmc_work(N_CHAINS, DIM, n_steps, N_COLLECT, N_LEAPFROG)
    b_ms, b_by = bound(n_bytes, f_ops + i_ops)
    unfused = unfused_ms(f_ops, i_ops)
    say("main", chains=N_CHAINS, dim=DIM, steps=f"{N_DISCARD}+{N_COLLECT}",
        step_size=STEP_SIZE, n_leapfrog=N_LEAPFROG, launches=counts["fused_hmc"],
        accept=f"{accept:.4f}", max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}",
        moment_audit=f"{audit:.5f}", wall_s=f"{wall:.5f}", kernel_ms=f"{ms:.3f}",
        grad_evals_per_s=f"{grad_evals / wall:.4e}", min_ess_per_s=f"{min_ess / wall:.4e}",
        plain_s=f"{plain_s:.3f}", plain_steps=n_steps, bound_ms=f"{b_ms:.3f}",
        bound_by=b_by, bound_unfused_ms=f"{unfused:.3f}",
        sm_clock_mhz=f"{max_sm_clock_hz() / 1e6:.0f}", lane_map=fused_hmc.lane_map(DIM),
        max_abs_err=err, diagnostics_ms=f"{diag_ms:.1f}")
    return dict(launches=counts["fused_hmc"], fill_launches=counts["counter_rng_fill"],
                max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3, bound_ms=b_ms, bound_by=b_by,
                bound_unfused_ms=unfused, accept=accept, max_rhat=max_rhat, audit=audit)


def phase_identity_mass(dev):
    """The use_mass=False branch at full width: a short run."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED + 1, device=dev)
    reset_counts()
    samples = gmt.HMC(target, x0, 0.25, N_LEAPFROG, seed=SEED + 1,
                      backend="cuda").run(20, 10)
    torch.cuda.synchronize()
    launches = fused_hmc.launches
    check(launches == 1, f"one fused HMC launch on the identity-mass path ({launches})")
    check(bool(torch.isfinite(samples).all()), "identity-mass samples are finite")
    plain = fused_hmc.fused_hmc_run_reference(target, x0, 0.25, N_LEAPFROG, 20, 10,
                                              seed=SEED + 1)
    err = compare(samples, plain, "K1 identity mass at full width")
    say("identity-mass", chains=N_CHAINS, dim=DIM, steps="10+20", launches=launches,
        max_abs_err=err)
    return dict(launches=launches, max_abs_err=err)


def phase_k1_split(dev):
    """K1's time split from outside: the main path's shape and 1,200 steps
    with 1, 10 and 20 leapfrogs, storing 1 and 1,000 samples, fitted to
    ``ms = steps·(a + b·n_leapfrog) + c·n_collect``: ``a`` is a step's fixed
    cost (draws, sums, accept), ``b`` a leapfrog's, ``c`` a stored row's."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev)
    mass_inv = (scales**2).to(dev)
    steps = N_COLLECT + N_DISCARD
    rows, times = [], []
    for n_leapfrog in (1, 10, 20):
        for n_collect in (1, N_COLLECT):
            run = lambda: fused_hmc.fused_hmc_run(
                target, x0, STEP_SIZE, n_leapfrog, n_collect, steps - n_collect, seed=SEED,
                mass_inv=mass_inv)
            ms, _, out = timed(run, 3)
            del out
            rows.append([steps, steps * n_leapfrog, n_collect])
            times.append(ms)
    fit = torch.linalg.lstsq(torch.tensor(rows, dtype=torch.float64),
                             torch.tensor(times, dtype=torch.float64)[:, None]).solution
    a_us, b_us, c_us = (float(v) * 1e3 for v in fit[:, 0])
    resid = float((torch.tensor(rows, dtype=torch.float64) @ fit
                   - torch.tensor(times, dtype=torch.float64)[:, None]).abs().max())
    at10 = a_us + b_us * N_LEAPFROG
    say("K1-split", chains=N_CHAINS, dim=DIM, steps=steps,
        ms=json.dumps({f"L{r[1] // steps}_c{r[2]}": round(t, 3) for r, t in zip(rows, times)}),
        a_us_per_step=f"{a_us:.4f}", b_us_per_leapfrog=f"{b_us:.4f}",
        c_us_per_row=f"{c_us:.4f}", a_share_at_L10=f"{a_us / at10:.3f}",
        max_fit_residual_ms=f"{resid:.3f}")
    return dict(a_us=a_us, b_us=b_us, c_us=c_us)


def phase_k1_maps(dev):
    """The main path's run (chains, steps, leapfrogs) at widths 33, 70 and
    the main path's 100 under every lane map the kernel takes at that width
    (lanes per chain x quads per lane).  The draws are addressed by (chain,
    step, quad), so every map must give the same bits; the times say whether
    the wrapper's choice (the first of each width) is the fastest.  At 33
    and 70 the first map has three quads a lane and fewer lane slots than
    the others; at 100 all three have 32 slots."""
    f32 = dict(device=dev, dtype=torch.float32)
    times = {}
    for d in K1_MAP_WIDTHS:
        scales = torch.exp(torch.linspace(0.0, math.log(10.0), d))
        target = gmt.GaussianND(torch.zeros(d), scales, device=dev)
        x0 = gmt.init_with_seed(N_CHAINS, d, SEED, device=dev)
        params = fused_hmc.target_params(target, fused_hmc.TARGET_GAUSSIAN_DIAG, **f32)
        inv_row = (scales**2).to(**f32)
        scale_row = 1.0 / torch.sqrt(inv_row)
        first, times[d] = None, {}
        for g, qpl in fused_hmc.lane_maps(d):
            out = torch.empty((N_COLLECT, N_CHAINS, d), **f32)
            run = lambda: fused_hmc._launch(x0, params, inv_row, scale_row, out, N_DISCARD, 1,
                                            N_LEAPFROG, STEP_SIZE, SEED, True, (g, qpl))
            ms, _, _ = timed(run, 3)
            times[d][f"{g}x{qpl}"] = round(ms, 3)
            if first is None:
                first = out
            else:
                check(torch.equal(out, first),
                      f"K1 lane map {g}x{qpl} at d={d} equals the chosen map's bits")
            del out
        del first
    chosen = {d: next(iter(t)) for d, t in times.items()}
    fastest = {d: min(t, key=t.get) for d, t in times.items()}
    say("K1-maps", chains=N_CHAINS, widths=list(times), all_equal=True,
        chosen=json.dumps(chosen), fastest=json.dumps(fastest), ms=json.dumps(times))
    return dict(times=times[DIM], chosen=chosen[DIM])


def phase_mh_small(dev):
    """K3 against its plain version at 256 chains and at 200 (a block's
    walkers or lanes past the last chain): each device target with each
    device proposal, thin = 2 after 5 burn-in steps, equal bit for bit.
    GaussianND at 1 and 2 (a thread a chain, as the 2-d targets; one
    dimension stored alone), 7 (four lanes, an odd number of normal pairs:
    the uniform shares the last block), 8 (four lanes, even: the uniform's
    block of its own), 33 (16 lanes, odd width), 70 (a warp a chain) and
    512 (a warp, five blocks a lane) covers every build's draws and
    stores."""
    gen = torch.Generator().manual_seed(17)
    targets = {
        "Gaussian2D": (gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev), 2, 1.0, 0.6),
        "Rosenbrock2D": (gmt.Rosenbrock2D(1.0, 10.0), 2, 0.5, 0.4),
    }
    for d in (1, 2, 7, 8, 33, 70, 512):
        mean = torch.randn(d, generator=gen) * 0.3
        scales = torch.exp(torch.randn(d, generator=gen) * 0.3)
        targets[f"GaussianND-{d}"] = (gmt.GaussianND(mean, scales, device=dev), d,
                                      1.5 / math.sqrt(d), 0.9 / math.sqrt(d))
    errs, rates = [], []
    for (name, (target, d, scale, beta)), n in itertools.product(targets.items(), (256, 200)):
        x0 = gmt.init_with_seed(n, d, 3, device=dev)
        for proposal in (gmt.RandomWalkProposal(scale), gmt.PCNProposal(beta)):
            args, kw = (target, x0, proposal, 20, 5), dict(seed=11, thin=2)
            got = fused_mh.fused_mh_run(*args, **kw)
            want = fused_mh.fused_mh_run_reference(*args, **kw)
            torch.cuda.synchronize()
            what = f"K3 {name} {type(proposal).__name__} at {n} chains"
            check(tuple(got.shape) == (n, 20, d), f"{what}: output shape")
            errs.append(compare(got, want, what))
            check(torch.equal(got, want), f"{what}: equal to the plain version bit for bit")
            moved = float((got[:, 1:] != got[:, :-1]).any(dim=2).float().mean())
            check(0.02 < moved < 0.999, f"{what}: accepts and rejects both occur ({moved})")
            rates.append(moved)
    # pCN on a standard normal: the Hastings ratio is 1, so every step moves
    std_normal = gmt.GaussianND(torch.zeros(2), torch.ones(2), device=dev)
    x0 = gmt.init_det(256, 2, device=dev)
    s = fused_mh.fused_mh_run(std_normal, x0, gmt.PCNProposal(0.6), 50, 0, seed=1)
    check(bool((s[:, 1:] != s[:, :-1]).any(dim=2).all()), "K3 pCN identity: every step moves")
    # thinning: thin = 3 keeps exactly every third state of the unthinned run
    walk = gmt.RandomWalkProposal(0.7)
    full = fused_mh.fused_mh_run(std_normal, x0, walk, 12, 4, seed=3)
    thin = fused_mh.fused_mh_run(std_normal, x0, walk, 4, 4, seed=3, thin=3)
    check(torch.equal(thin, full[:, 2::3]), "K3 thinning identity")
    say("K3-small", cases=len(errs), chains="256,200", bit_equal=True, max_abs_err=max(errs),
        moved_min=f"{min(rates):.3f}", moved_max=f"{max(rates):.3f}", pcn_identity=True,
        thinning_identity=True)
    return dict(max_abs_err=max(errs))


def mh_main_sampler(dev):
    """The MH main path: its target, proposal, initial states and a factory
    of its sampler (the 2-d Gaussian, 16,384 chains, the fused kernel)."""
    target = gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev)
    proposal = gmt.RandomWalkProposal(MH_SCALE)
    x0 = gmt.init_det(MH_CHAINS, 2, device=dev)
    return target, proposal, x0, lambda: gmt.MetropolisHastings(target, proposal, x0,
                                                                seed=SEED, backend="cuda")


def phase_mh_main(dev):
    """The MH main path at full size through the user's entry point."""
    target, proposal, x0, sampler = mh_main_sampler(dev)

    reset_counts()
    samples = sampler().run(MH_COLLECT, MH_DISCARD)
    torch.cuda.synchronize()
    launches = fused_mh.launches
    store = samples.transpose(0, 1)  # the steps-major [n_collect, n, 2] store
    rhat, ess = gmt.split_rhat_mean_ess(store, steps_major=True)
    diag_ms, _, _ = timed(lambda: gmt.split_rhat_mean_ess(store, steps_major=True), 1)

    check(launches == 1, f"one fused MH launch on the MH main path ({launches})")
    check(tuple(samples.shape) == (MH_CHAINS, MH_COLLECT, 2), "MH sample shape")
    check(bool(torch.isfinite(store).all()), "every MH sample is finite")
    flat = store.reshape(-1, 2)
    mean = flat.mean(dim=0, dtype=torch.float64)
    centred = flat.double() - mean
    cov = centred.T @ centred / (flat.shape[0] - 1)
    del centred
    mean_err = float((mean.cpu() - torch.tensor(MH_MEAN, dtype=torch.float64)).abs().max())
    cov_err = float((cov.cpu() - torch.tensor(MH_COV, dtype=torch.float64)).abs().max())
    check(mean_err < MH_MEAN_ATOL, f"pooled mean within {MH_MEAN_ATOL} ({mean_err})")
    check(cov_err < MH_COV_ATOL, f"pooled covariance within {MH_COV_ATOL} ({cov_err})")
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    check(max_rhat < 1.01, f"MH max R-hat {max_rhat} < 1.01")
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())

    # the same run through the plain version, on the same inputs
    t0 = time.perf_counter()
    plain = fused_mh.fused_mh_run_reference(target, x0, proposal, MH_COLLECT, MH_DISCARD,
                                            seed=SEED)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = compare(samples, plain, "K3 at full size")
    check(torch.equal(samples, plain), "K3 at full size: equal to the plain version bit for bit")
    del plain, samples, store, flat

    ms, wall, out = timed(lambda: sampler().run(MH_COLLECT, MH_DISCARD), 3)
    del out
    n_steps = MH_COLLECT + MH_DISCARD
    work = (MH_CHAINS, 2, n_steps, MH_COLLECT, MH_TARGET_OPS, MH_PROPOSAL_OPS)
    n_bytes, f_ops, i_ops = fused_mh_work(*work)
    b_ms, b_by = bound(n_bytes, f_ops + i_ops)
    unfused = unfused_ms(f_ops, i_ops)
    o_bytes, o_f, o_i = fused_mh_work_two_blocks(*work)
    old_ms, _ = bound(o_bytes, o_f + o_i)
    old_unfused = unfused_ms(o_f, o_i)
    n_samples = MH_CHAINS * MH_COLLECT
    say("mh-main", chains=MH_CHAINS, dim=2, steps=f"{MH_DISCARD}+{MH_COLLECT}",
        samples=n_samples, store_mb=f"{4 * 2 * n_samples / 1e6:.0f}", launches=launches,
        accept=f"{accept:.4f}", mean_err=f"{mean_err:.5f}", cov_err=f"{cov_err:.5f}",
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}", wall_s=f"{wall:.5f}",
        kernel_ms=f"{ms:.3f}", samples_per_s=f"{n_samples / wall:.4e}",
        min_ess_per_s=f"{min_ess / wall:.4e}", plain_s=f"{plain_s:.3f}",
        plain_steps=n_steps, bound_ms=f"{b_ms:.3f}", bound_by=b_by,
        bound_unfused_ms=f"{unfused:.3f}", bound_two_block_layout_ms=f"{old_ms:.3f}",
        bound_two_block_layout_unfused_ms=f"{old_unfused:.3f}",
        max_abs_err=err, diagnostics_ms=f"{diag_ms:.1f}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
                bound_ms=b_ms, bound_by=b_by, bound_unfused_ms=unfused, diagnostics_ms=diag_ms)


def phase_k3_chains(dev):
    """K3 at the MH main path's width and steps at 4,096, 16,384 and 65,536
    chains: the kernel's device time over back-to-back launches (no wrapper
    between the events) and samples/s at each, which say whether the main
    shape (one warp a scheduler) is still latency-bound; the plain version
    is not run here (at 65,536 chains the store is 2.6 GB)."""
    target = gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev)
    proposal = gmt.RandomWalkProposal(MH_SCALE)
    n_steps = MH_COLLECT + MH_DISCARD
    f32 = dict(device=dev, dtype=torch.float32)
    rates, times = {}, {}
    for n in MH_CHAIN_COUNTS:
        x0 = gmt.init_det(n, 2, device=dev)
        code, p_code, consts = fused_mh._check_args(target, x0, proposal, MH_COLLECT,
                                                    MH_DISCARD, 1)
        params = fused_hmc.target_params(target, code, **f32)
        out = torch.empty((MH_COLLECT, n, 2), **f32)
        ms = device_ms(functools.partial(fused_mh._launch, x0, params, out, code, p_code,
                                         consts, MH_DISCARD, 1, SEED), 5)
        check(bool(torch.isfinite(out[-1]).all()), f"K3 at {n} chains: finite last samples")
        del out
        times[n] = round(ms, 4)
        rates[n] = f"{n * MH_COLLECT / (ms * 1e-3):.4e}"
    say("K3-chains", steps=n_steps, dim=2, kernel_ms=json.dumps(times),
        samples_per_s=json.dumps(rates))
    return dict(ms=times, samples_per_s=rates)


def phase_k3_widths(dev):
    """K3 on the wider maps: ``fused_mh_run`` on a diagonal GaussianND at
    widths 100 (a warp a chain, a block a lane) and 512 (five blocks a
    lane), 16,384 chains, 500 burn-in steps and 100 samples at thin 5, the
    random walk; device time over back-to-back calls (the host's work in a
    call overlaps the kernel's), bound as for the main path.  It calls only
    the public entry points, so it times an earlier version of the package
    as well."""
    times, bounds = {}, {}
    n, discard, collect, thin = MH_WIDTH_CHAINS, 500, 100, 5
    for d in MH_WIDTHS:
        gen = torch.Generator().manual_seed(d)
        target = gmt.GaussianND(torch.randn(d, generator=gen) * 0.3,
                                torch.exp(torch.randn(d, generator=gen) * 0.3), device=dev)
        x0 = gmt.init_with_seed(n, d, 3, device=dev)
        run = functools.partial(fused_mh.fused_mh_run, target, x0,
                                gmt.RandomWalkProposal(1.5 / math.sqrt(d)), collect, discard,
                                seed=SEED, thin=thin)
        out = run()
        check(tuple(out.shape) == (n, collect, d) and bool(torch.isfinite(out[:, -1]).all()),
              f"K3 at width {d}: shape and finite last samples")
        del out
        times[d] = round(device_ms(run, 3), 4)
        # GaussianND: a difference, a square, a product with the precision
        # and a sum per coordinate, and the scale
        work = fused_mh_work(n, d, discard + collect * thin, collect, 4 * d + 1, MH_PROPOSAL_OPS)
        bounds[d] = round(bound(work[0], work[1] + work[2])[0], 4)
    say("K3-widths", chains=n, steps=discard + collect * thin, kernel_ms=json.dumps(times),
        bound_ms=json.dumps(bounds))
    return dict(ms=times, bound_ms=bounds)


# sha256 of K4's float32 output for k4_digests' inputs after 1, 8 and 64
# steps at lr 1e-3 (tests/test_torch_cuda_targets.py's K4_DIGESTS): K4's
# bits before logistic_tile.cuh was shared with the HMC kernel, which every
# later change to that header keeps.
K4_DIGESTS = {
    1: "94e01007b42ffd7a72934ca924a7bd08ac09b698c8cfee1c4a104341ae51d35a",
    8: "caba45faf608ac04439869bd50deae324beed28c3a2807cc650dfbbceec3f677",
    64: "ae3409315708c68f7da20c4f06207cff085b93db6f4910f08ef0daac08efb507",
}


def k4_digests(dev):
    """K4's output on numpy's seed-12 inputs (X [256, 48], y [256], theta0
    [1000, 50]) equal to K4_DIGESTS."""
    rng = np.random.default_rng(12)
    X = torch.from_numpy(rng.normal(size=(256, 48)).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.uniform(size=256) < 0.5).astype(np.float32)).to(dev)
    theta0 = torch.from_numpy((0.1 * rng.normal(size=(1000, 50))).astype(np.float32)).to(dev)
    for steps, want in K4_DIGESTS.items():
        out = fused_logistic.fused_logistic_chain(theta0, X, y, steps, 1e-3)
        got = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        check(got == want, f"K4's output after {steps} steps has its digest ({got})")
    say("K4-digests", steps=sorted(K4_DIGESTS), equal=True)


def phase_logistic(dev):
    """K4 at the probe's shape: agreement with the plain version after 1, 8,
    64 and 512 steps, then the 512-step chain timed."""
    X, y, _ = gmt.make_logistic_data(SEED + 1, LG_OBS, LG_FEATURES, device=dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    theta0 = (0.1 * torch.randn((LG_CHAINS, LG_FEATURES + 2), generator=gen)).to(dev)
    target = gmt.HierarchicalLogisticNC(X, y)
    chain = lambda steps: fused_logistic.fused_logistic_chain(theta0, X, y, steps, LG_LR)
    plain = lambda steps: fused_logistic.fused_logistic_chain_reference(theta0, X, y, steps,
                                                                        LG_LR)
    # small ragged sizes: chains no multiple of a tile's 32, features and
    # observations no multiples of 8, one case for each feature-tile build;
    # and one with enough chains for three chain tiles a block whose X leaves
    # room for two (one step: at 300 observations eight steps take the plain
    # version in float32 further than the gate from itself in float64)
    ragged = {}
    for n, p, n_obs, steps in ((77, 13, 37, 8), (100, 20, 50, 8), (45, 33, 21, 8),
                               (9000, 48, 300, 1)):
        Xr, yr, _ = gmt.make_logistic_data(SEED + 3, n_obs, p, device=dev)
        tr = (0.1 * torch.randn((n, p + 2), generator=gen)).to(dev)
        got = fused_logistic.fused_logistic_chain(tr, Xr, yr, steps, LG_LR)
        want = fused_logistic.fused_logistic_chain_reference(tr, Xr, yr, steps, LG_LR)
        err = float((got - want).abs().max() / want.abs().max())
        check(tuple(got.shape) == (n, p + 2) and err < LG_RTOL[steps],
              f"K4 ragged {n}x{p}x{n_obs} after {steps} steps: relative error {err} "
              f"< {LG_RTOL[steps]}")
        ragged[f"{n}x{p}x{n_obs}@{steps}"] = f"{err:.3e}"
    say("K4-ragged", rel_err=json.dumps(ragged))
    k4_digests(dev)

    rel, abs_err = {}, 0.0
    for steps in (1, 8, 64):
        got, want = chain(steps), plain(steps)
        rel[steps] = float((got - want).abs().max() / want.abs().max())
        abs_err = max(abs_err, float((got - want).abs().max()))

    # the path itself: one launch carries all 512 steps
    reset_counts()
    theta = chain(LG_STEPS)
    torch.cuda.synchronize()
    launches = fused_logistic.launches
    check(launches == 1, f"one fused logistic launch for the whole chain ({launches})")
    check(tuple(theta.shape) == (LG_CHAINS, LG_FEATURES + 2), "logistic state shape")
    check(bool(torch.isfinite(theta).all()), "every logistic state is finite")
    climbed = target.unnorm_logp(theta) > target.unnorm_logp(theta0)
    check(bool(climbed.all()), "every chain climbed its log density")
    want = plain(LG_STEPS)
    rel[LG_STEPS] = float((theta - want).abs().max() / want.abs().max())
    abs_err = max(abs_err, float((theta - want).abs().max()))
    say("K4-agreement", **{f"rel_err_{k}": f"{v:.3e}" for k, v in rel.items()},
        max_abs_err=abs_err)
    for steps, limit in LG_RTOL.items():
        check(rel[steps] < limit, f"K4 after {steps} steps: relative error {rel[steps]} "
              f"< {limit}")
    del theta, want

    ms, wall, _ = timed(lambda: chain(LG_STEPS), 3)
    plain_ms, _, _ = timed(lambda: plain(LG_STEPS), 3)
    # the yardstick: the two torch.matmul of one step at this shape, alone,
    # times the steps
    library_ms = library_matmul_ms(dev, [((LG_CHAINS, LG_FEATURES), (LG_FEATURES, LG_OBS)),
                                         ((LG_CHAINS, LG_OBS), (LG_OBS, LG_FEATURES))], LG_STEPS)
    # the bound: the lesser of the CUDA cores doing the products in float32
    # and the tensor cores doing the three TF32 passes that float32 accuracy
    # costs, each with the other operations on the CUDA cores
    n_bytes, flops, other = fused_logistic_work(LG_CHAINS, LG_FEATURES, LG_OBS, LG_STEPS)
    cuda_core_ms, _ = bound(n_bytes, flops + other)
    tensor_ms = max(bound(n_bytes, 3 * flops, TF32_OPS_PER_S)[0], bound(n_bytes, other)[0])
    b_ms, b_by = min(cuda_core_ms, tensor_ms), "operations"
    say("K4", chains=LG_CHAINS, features=LG_FEATURES, n_obs=LG_OBS, steps=LG_STEPS,
        launches=launches, rel_err_1=f"{rel[1]:.3e}", rel_err_8=f"{rel[8]:.3e}",
        rel_err_64=f"{rel[64]:.3e}", rel_err_512=f"{rel[LG_STEPS]:.3e}",
        max_abs_err=abs_err, kernel_ms=f"{ms:.3f}",
        wall_s=f"{wall:.5f}", us_per_grad=f"{ms * 1e3 / LG_STEPS:.3f}",
        tflops=f"{flops / (ms * 1e-3) / 1e12:.3f}", plain_ms=f"{plain_ms:.3f}",
        plain_us_per_grad=f"{plain_ms * 1e3 / LG_STEPS:.3f}", bound_ms=f"{b_ms:.3f}",
        bound_by=b_by, bound_cuda_core_ms=f"{cuda_core_ms:.3f}",
        bound_tensor_3xtf32_ms=f"{tensor_ms:.3f}", library_ms=f"{library_ms:.3f}")
    return dict(launches=launches, max_abs_err=abs_err, rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                bound_cuda_core_ms=cuda_core_ms, bound_tensor_ms=tensor_ms)


def target_hmc_work(n: int, d: int, n_steps: int, n_collect: int, n_leapfrog: int,
                    grad_ops: float, value_ops: float):
    """Bytes, float operations and integer operations of one fused HMC run
    on a target whose gradient costs ``grad_ops`` and log density
    ``value_ops`` a chain: x0 read and the store written once; per element
    and step the draws, the energies and the select (as fused_hmc_work's),
    5 a leapfrog (the drift and the kick); the target's own operations."""
    n_bytes = 4 * n * d * (1 + n_collect)
    per_step = d * (10 + 11 + 1 + 5 * n_leapfrog) + grad_ops * n_leapfrog + value_ops
    return n_bytes, n * n_steps * per_step, n * n_steps * d * PHILOX_OPS / 4


def target_ops(family: str, d: int):
    """``(gradient, log density)`` operations a chain of a target family at
    width ``d``: the 2-d quadratic forms and Rosenbrock with autograd's
    backward pass; RosenbrockND's neighbour terms; the funnel's sum of
    squares and its exp (the dense Gaussian's: tile_bounds)."""
    return {"2d": (22, 10), "rosenbrock_nd": (10 * d, 5 * d),
            "funnel": (4 * d + 15, 2 * d + 15)}[family]


def dense_target(d: int, dev):
    """GaussianND(zeros(d), D R D) with D the headline's scales and R_ij =
    0.5^|i-j|, and D."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    return gmt.GaussianND(torch.zeros(d), cov.float(), device=dev), scales.float()


def small_targets(dev):
    """name -> (target, width, ε, L, random-walk scale) of "K1-targets" and
    "K3-targets"'s small cases: the widths take every lane map of both
    kernels (one quad or block a lane to four or five, odd widths)."""
    g2 = (MH_MEAN, MH_COV)
    cases = {"DiffableGaussian2D": (gmt.DiffableGaussian2D(*g2, device=dev), 2, 0.25, 10, 1.0),
             "Gaussian2D": (gmt.Gaussian2D(*g2, device=dev), 2, 0.25, 10, None),
             "Rosenbrock2D": (gmt.Rosenbrock2D(1.0, 10.0), 2, 0.05, 10, None)}
    for d in (3, 7, 33, 100, 512):
        cases[f"RosenbrockND-{d}"] = (gmt.RosenbrockND(), d, 0.01 if d < 100 else 1e-4, 20,
                                      0.1 / math.sqrt(d))
    for d in (10, 33, 512):
        cases[f"NealsFunnel-{d}"] = (gmt.NealsFunnel(d), d, 0.1, 10, 1.0 / math.sqrt(d))
    return cases


def equal_or_close(got, want, what, bit: bool):
    """``compare`` (K1's tolerance, no chain differing) and, with ``bit``,
    equality bit for bit; returns max |Δ| and whether the bits are equal."""
    err = compare(got, want, what)
    same = bool(torch.equal(got, want))
    if bit:
        check(same, f"{what}: equal to the plain version bit for bit")
    return err, same


def moment_errors(store, mean, cov):
    """Pooled mean and covariance errors of a 2-d store against the
    target's, in float64."""
    flat = store.reshape(-1, 2)
    m = flat.mean(dim=0, dtype=torch.float64)
    centred = flat.double() - m
    c = centred.T @ centred / (flat.shape[0] - 1)
    return (float((m.cpu() - torch.tensor(mean, dtype=torch.float64)).abs().max()),
            float((c.cpu() - torch.tensor(cov, dtype=torch.float64)).abs().max()))


def timed_pair(kernel, plain, n: int, d: int, n_steps: int, n_collect: int, work, what: str,
               bit: bool):
    """A family's timed run: the kernel (median of 3, CUDA events) and its
    plain version (once) on the same inputs, compared; the bound of
    ``work = (bytes, float ops, int ops)``."""
    ms, _, got = timed(kernel, 3)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, same = equal_or_close(got, want, what, bit)
    b_ms, b_by = bound(work[0], work[1] + work[2])
    return dict(ms=round(ms, 4), plain_ms=round(plain_ms, 2), bound_ms=round(b_ms, 5),
                bound_by=b_by, max_abs_err=err, bit_equal=same,
                shape=f"{n}x{d}, {n_steps} steps")


def phase_k1_targets(dev):
    """K1 on the 2-d targets, RosenbrockND and NealsFunnel: against its
    plain version at small shapes (identity and diagonal mass); each family
    timed beside its plain version; the gate runs through ``HMC``."""
    errs, same = [], []
    for name, (t, d, eps, n_leap, _) in small_targets(dev).items():
        for n in TG_SMALL_CHAINS:
            x0 = (0.3 * gmt.init_with_seed(n, d, 3, device=dev)).contiguous()
            gen = torch.Generator().manual_seed(d)
            for mass_inv in (None, torch.exp(0.2 * torch.randn(d, generator=gen)).to(dev)):
                args, kw = (t, x0, eps, n_leap, 20, 5), dict(seed=11, thin=2, mass_inv=mass_inv)
                got = fused_hmc.fused_hmc_run(*args, **kw)
                want = fused_hmc.fused_hmc_run_reference(*args, **kw)
                torch.cuda.synchronize()
                check(tuple(got.shape) == (n, 20, d), f"K1 {name} output shape")
                err, bits = equal_or_close(got, want, f"K1 {name} at {n} chains "
                                           f"mass={mass_inv is not None}", bit=False)
                errs.append(err)
                same.append(bits)

    # each family timed beside its plain version on the same inputs
    fam = {}
    g2 = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    runs = {"2d": (g2, 2, N_CHAINS, TG_2D_EPS, TG_2D_L),
            "rosenbrock_nd": (gmt.RosenbrockND(), ROSEN_WIDE_D, ROSEN_WIDE_CHAINS,
                              ROSEN_WIDE_EPS, ROSEN_WIDE_L),
            "funnel": (gmt.NealsFunnel(10), 10, FUNNEL_CHAINS, FUNNEL_EPS, FUNNEL_L)}
    for family, (t, d, n, eps, n_leap) in runs.items():
        x0 = (0.3 * gmt.init_with_seed(n, d, SEED, device=dev)).contiguous()
        args = (t, x0, eps, n_leap, TG_TIMED_STEPS, 0)
        work = target_hmc_work(n, d, TG_TIMED_STEPS, TG_TIMED_STEPS, n_leap,
                               *target_ops(family, d))
        fam[family] = timed_pair(lambda: fused_hmc.fused_hmc_run(*args, seed=SEED),
                                 lambda: fused_hmc.fused_hmc_run_reference(*args, seed=SEED),
                                 n, d, TG_TIMED_STEPS, TG_TIMED_STEPS, work,
                                 f"K1 {family} timed run", bit=False)

    # the gate runs through the sampler: the DiffableGaussian2D at the main
    # path's chains, the 3-d Rosenbrock as its example runs it
    x0 = gmt.init_det(N_CHAINS, 2, device=dev)
    reset_counts()
    samples = gmt.HMC(g2, x0, TG_2D_EPS, TG_2D_L, seed=SEED, backend="cuda").run(*TG_2D_STEPS)
    torch.cuda.synchronize()
    launches = fused_hmc.launches
    check(launches == 1, f"one fused HMC launch on the DiffableGaussian2D run ({launches})")
    store = samples.transpose(0, 1)
    check(bool(torch.isfinite(store).all()), "DiffableGaussian2D samples are finite")
    mean_err, cov_err = moment_errors(store, MH_MEAN, MH_COV)
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())
    check(mean_err < MH_MEAN_ATOL and cov_err < MH_COV_ATOL,
          f"K1 DiffableGaussian2D mean error {mean_err} < {MH_MEAN_ATOL}, covariance "
          f"{cov_err} < {MH_COV_ATOL}")
    del samples, store
    rosen = gmt.RosenbrockND()
    x3 = gmt.init_det(ROSEN3_CHAINS, 3, device=dev)
    sampler = gmt.HMC(rosen, x3, ROSEN3_EPS, ROSEN3_L, backend="cuda").set_seed(ROSEN3_SEED)
    r3 = sampler.run(*ROSEN3_STEPS)
    torch.cuda.synchronize()
    check(tuple(r3.shape) == (ROSEN3_CHAINS, ROSEN3_STEPS[0], 3)
          and bool(torch.isfinite(r3).all()), "rosenbrock3d_hmc's run: shape and finite")
    args = (rosen, x3, ROSEN3_EPS, ROSEN3_L, ROSEN3_COMPARE_STEPS, 0)
    err3, _ = equal_or_close(fused_hmc.fused_hmc_run(*args, seed=sampler._key),
                             fused_hmc.fused_hmc_run_reference(*args, seed=sampler._key),
                             "K1 3-d Rosenbrock", bit=False)
    errs.append(err3)
    say("K1-targets", small_cases=len(errs) - 1, rtol=K1_RTOL, atol=K1_ATOL,
        max_abs_err=max(errs), bit_equal=f"{sum(same)}/{len(same)}",
        families=json.dumps(fam), diffable2d_launches=launches,
        diffable2d=f"{N_CHAINS}x{TG_2D_STEPS[1]}+{TG_2D_STEPS[0]}", accept=f"{accept:.4f}",
        mean_err=f"{mean_err:.5f}", cov_err=f"{cov_err:.5f}",
        rosenbrock3d=f"{ROSEN3_CHAINS}x{ROSEN3_STEPS[1]}+{ROSEN3_STEPS[0]}",
        rosenbrock3d_max_abs_err=err3)
    return dict(max_abs_err=max(errs), families=fam, launches=launches)


def phase_k3_targets(dev):
    """K3 on DiffableGaussian2D, RosenbrockND and NealsFunnel: equal to its
    plain version bit for bit at small shapes with both proposals; each
    family timed beside its plain version; the DiffableGaussian2D at the MH
    main path's shape through ``MetropolisHastings``."""
    errs = []
    for name, (t, d, _, _, scale) in small_targets(dev).items():
        if scale is None:  # Gaussian2D and Rosenbrock2D: "K3-small"'s
            continue
        for n in TG_SMALL_CHAINS:
            x0 = (0.3 * gmt.init_with_seed(n, d, 3, device=dev)).contiguous()
            for proposal in (gmt.RandomWalkProposal(scale), gmt.PCNProposal(0.3)):
                args, kw = (t, x0, proposal, 20, 5), dict(seed=11, thin=2)
                got = fused_mh.fused_mh_run(*args, **kw)
                want = fused_mh.fused_mh_run_reference(*args, **kw)
                torch.cuda.synchronize()
                what = f"K3 {name} {type(proposal).__name__} at {n} chains"
                check(tuple(got.shape) == (n, 20, d), f"{what}: output shape")
                errs.append(equal_or_close(got, want, what, bit=True)[0])

    fam = {}
    g2 = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    runs = {"2d": (g2, 2, MH_CHAINS, MH_SCALE),
            "rosenbrock_nd": (gmt.RosenbrockND(), ROSEN_WIDE_D, ROSEN_WIDE_CHAINS,
                              0.1 / math.sqrt(ROSEN_WIDE_D)),
            "funnel": (gmt.NealsFunnel(10), 10, FUNNEL_CHAINS, FUNNEL_WALK)}
    for family, (t, d, n, scale) in runs.items():
        x0 = (0.3 * gmt.init_with_seed(n, d, SEED, device=dev)).contiguous()
        args = (t, x0, gmt.RandomWalkProposal(scale), TG_TIMED_STEPS, 0)
        work = fused_mh_work(n, d, TG_TIMED_STEPS, TG_TIMED_STEPS, target_ops(family, d)[1],
                             MH_PROPOSAL_OPS)
        fam[family] = timed_pair(lambda: fused_mh.fused_mh_run(*args, seed=SEED),
                                 lambda: fused_mh.fused_mh_run_reference(*args, seed=SEED),
                                 n, d, TG_TIMED_STEPS, TG_TIMED_STEPS, work,
                                 f"K3 {family} timed run", bit=True)

    x0 = gmt.init_det(MH_CHAINS, 2, device=dev)
    reset_counts()
    samples = gmt.MetropolisHastings(g2, gmt.RandomWalkProposal(MH_SCALE), x0, seed=SEED,
                                     backend="cuda").run(MH_COLLECT, MH_DISCARD)
    torch.cuda.synchronize()
    launches = fused_mh.launches
    check(launches == 1, f"one fused MH launch on the DiffableGaussian2D run ({launches})")
    store = samples.transpose(0, 1)
    check(bool(torch.isfinite(store).all()), "K3 DiffableGaussian2D samples are finite")
    mean_err, cov_err = moment_errors(store, MH_MEAN, MH_COV)
    rhat, _ = gmt.split_rhat_mean_ess(store, steps_major=True)
    max_rhat = float(rhat.max())
    check(mean_err < MH_MEAN_ATOL and cov_err < MH_COV_ATOL and max_rhat < 1.01,
          f"K3 DiffableGaussian2D mean error {mean_err} < {MH_MEAN_ATOL}, covariance "
          f"{cov_err} < {MH_COV_ATOL}, R-hat {max_rhat} < 1.01")
    say("K3-targets", small_cases=len(errs), bit_equal=True, max_abs_err=max(errs),
        families=json.dumps(fam), diffable2d_launches=launches,
        diffable2d=f"{MH_CHAINS}x{MH_DISCARD}+{MH_COLLECT}", mean_err=f"{mean_err:.5f}",
        cov_err=f"{cov_err:.5f}", max_rhat=f"{max_rhat:.5f}")
    return dict(max_abs_err=max(errs), families=fam, launches=launches)


def phase_wide_equal(dev):
    """Both wide kernels against their plain versions, bit for bit, at
    WIDE_EQ_WIDTHS on every lane target (K1 with and without a diagonal
    M⁻¹, K3 with the random walk and pCN), and from chain WIDE_CHAIN0: rows
    of the launch from 0.  The cases are tests/torch_wide_cases.py's, which
    tests/test_torch_cuda_wide.py holds the kernels to as well."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_wide_cases.py")
    spec = importlib.util.spec_from_file_location("torch_wide_cases", path)
    cases_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases_mod)
    wide_case = functools.partial(cases_mod.wide_case, chains=WIDE_EQ_CHAINS)

    errs, cases = {"K1": 0.0, "K3": 0.0}, 0
    for d in WIDE_EQ_WIDTHS:
        for name in ("gaussian", "rosenbrock", "funnel"):
            for mass in ((False, True) if name == "gaussian" else (False,)):
                target, x0, eps, _, _, mass_inv = wide_case(name, d, dev, mass=mass)
                args = (target, x0, eps, WIDE_EQ_L, WIDE_EQ_STEPS, 2)
                kw = dict(seed=3, mass_inv=mass_inv if mass else None)
                got = fused_hmc.fused_hmc_run(*args, **kw)
                want = fused_hmc.fused_hmc_run_reference(*args, **kw)
                what = f"K1 wide {name} d={d} mass={mass}"
                check(tuple(got.shape) == (WIDE_EQ_CHAINS, WIDE_EQ_STEPS, d)
                      and bool(torch.isfinite(got).all()), f"{what}: shape, finite")
                errs["K1"] = max(errs["K1"], float((got - want).abs().max()))
                check(torch.equal(got, want), f"{what}: equal to the plain version bit for "
                      f"bit ({int((got != want).any(2).any(1).sum())} chains differ)")
                cases += 1
            target, x0, _, walk, beta, _ = wide_case(name, d, dev)
            for proposal in (gmt.RandomWalkProposal(walk), gmt.PCNProposal(beta)):
                args = (target, x0, proposal, WIDE_EQ_STEPS, 4)
                got = fused_mh.fused_mh_run(*args, seed=5, thin=2)
                want = fused_mh.fused_mh_run_reference(*args, seed=5, thin=2)
                what = f"K3 wide {name} {type(proposal).__name__} d={d}"
                check(bool(torch.isfinite(got).all()), f"{what}: finite")
                errs["K3"] = max(errs["K3"], float((got - want).abs().max()))
                check(torch.equal(got, want), f"{what}: equal to the plain version bit for "
                      f"bit ({int((got != want).any(2).any(1).sum())} chains differ)")
                cases += 1
        # a launch from chain WIDE_CHAIN0 is rows WIDE_CHAIN0... of the launch from 0
        target, x0, eps, walk, _, _ = wide_case("rosenbrock", d, dev)
        rows = slice(WIDE_CHAIN0, WIDE_EQ_CHAINS)
        block = x0[rows].contiguous()
        for run, args in ((fused_hmc.fused_hmc_run, (eps, WIDE_EQ_L, 8, 1)),
                          (fused_mh.fused_mh_run, (gmt.RandomWalkProposal(walk), 8, 1))):
            full = run(target, x0, *args, seed=4)
            part = run(target, block, *args, seed=4, chain0=WIDE_CHAIN0)
            check(torch.equal(part, full[rows]), f"{run.__name__} wide d={d} from chain "
                  f"{WIDE_CHAIN0}: rows of the launch from 0")
    maps = {d: {"K1": fused_hmc.wide_map(d), "K3": fused_mh.wide_map(d)} for d in WIDE_EQ_WIDTHS}
    say("wide-equal", widths=list(WIDE_EQ_WIDTHS), chains=WIDE_EQ_CHAINS, steps=WIDE_EQ_STEPS,
        cases=cases, bit_equal=True, chain0=WIDE_CHAIN0, max_abs_err=json.dumps(errs),
        maps=json.dumps(maps))
    return dict(max_abs_err=errs, cases=cases, maps=maps)


def wide_gaussian(d: int, dev):
    """GaussianND(zeros(d), exp(linspace(0, log 10, d))), the headline's
    form at width d, and its scales."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d))
    return gmt.GaussianND(torch.zeros(d), scales, device=dev), scales


def wide_bounds(work, n_chains: int, wide) -> dict:
    """The bound of ``work`` over the whole card, and over the SMs the
    launch can occupy: ``n_chains`` clusters of ``wide[0]`` blocks, each
    block on an SM of its own at most."""
    b_ms, b_by = bound(work[0], work[1] + work[2])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    used = min(sms, n_chains * wide[0])
    return dict(bound_ms=round(b_ms, 5), bound_by=b_by, bound_sms_ms=round(b_ms * sms / used, 5),
                sms=used)


def phase_k1_wide(dev):
    """K1-wide: HMC(backend="cuda") on the headline's Gaussian at widths
    1,000 and 4,096 (K1_WIDE_RUNS): one launch of the wide kernel each,
    accept, R-hat and the moment audit, timed; the plain version over the
    same inputs, bit for bit."""
    rows = {}
    for d, (eps, n_collect, n_discard, thin) in K1_WIDE_RUNS.items():
        target, scales = wide_gaussian(d, dev)
        x0 = gmt.init_with_seed(N_CHAINS, d, SEED, device=dev)
        mass_inv = (scales**2).to(dev)
        sampler = lambda: gmt.HMC(target, x0, eps, N_LEAPFROG, seed=SEED, mass_inv=mass_inv,
                                  backend="cuda")
        reset_counts()
        samples = sampler().run(n_collect, n_discard, thin=thin)
        torch.cuda.synchronize()
        launches = fused_hmc.wide_launches
        check(launches == 1 and fused_hmc.launches == 0,
              f"K1-wide d={d}: one launch of the wide kernel ({launches})")
        store = samples.transpose(0, 1)
        check(tuple(samples.shape) == (N_CHAINS, n_collect, d)
              and bool(torch.isfinite(store).all()), f"K1-wide d={d}: shape, finite")
        rhat, _, _, std = gmt.split_rhat_mean_ess(store, steps_major=True, return_moments=True)
        max_rhat = float(rhat.max())
        audit = float((std.cpu() / scales - 1.0).abs().max())
        del rhat, std
        short = sampler().run(WIDE_ACCEPT_STEPS, n_discard)
        accept = float((short[:, 1:] != short[:, :-1]).any(dim=2).float().mean())
        del short
        check(0.6 < accept < 0.95, f"K1-wide d={d}: accept {accept} within 0.6-0.95")
        check(max_rhat < 1.01, f"K1-wide d={d}: max R-hat {max_rhat} < 1.01")
        check(audit < 0.05, f"K1-wide d={d}: moment audit {audit} < 0.05")
        # the plain version: the whole run at 1,000, a shorter one at 4,096
        plain_args = (n_collect, n_discard, thin) if d == 1000 else K1_WIDE_PLAIN_STEPS
        got = samples if d == 1000 else sampler().run(*plain_args[:2], thin=plain_args[2])
        del samples, store
        t0 = time.perf_counter()
        want = fused_hmc.fused_hmc_run_reference(target, x0, eps, N_LEAPFROG, plain_args[0],
                                                 plain_args[1], seed=SEED, thin=plain_args[2],
                                                 mass_inv=mass_inv)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"K1-wide d={d}: the kernel equals its plain version "
              f"bit for bit ({int((got != want).any(2).any(1).sum())} chains differ)")
        del got, want
        ms, wall, out = timed(lambda: sampler().run(n_collect, n_discard, thin=thin), 3)
        del out
        n_steps = n_discard + n_collect * thin
        wide = fused_hmc.wide_map(d)
        rows[d] = dict(ms=round(ms, 4), wall_s=round(wall, 5), launches=launches,
                       plain_ms=round(plain_ms, 2),
                       plain_steps=plain_args[1] + plain_args[0] * plain_args[2],
                       max_abs_err=err, accept=round(accept, 4), max_rhat=round(max_rhat, 5),
                       audit=round(audit, 5), eps=eps, map=wide, steps=n_steps,
                       shape=f"{N_CHAINS}x{d}, {n_discard}+{n_collect}x{thin} steps",
                       **wide_bounds(fused_hmc_work(N_CHAINS, d, n_steps, n_collect,
                                                    N_LEAPFROG), N_CHAINS, wide))
        torch.cuda.empty_cache()
    say("K1-wide", **{str(d): json.dumps(r) for d, r in rows.items()})
    return dict(rows=rows, launches=sum(r["launches"] for r in rows.values()),
                max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def phase_hmc_stress(dev):
    """The reference's HMC stress case on the wide kernel: RosenbrockND at
    10,000 dimensions, 6 chains, 200 steps of 50 leapfrogs through
    HMC(backend="cuda"): one launch, the shape, finite, equal to
    backend="torch" bit for bit; timed."""
    target = gmt.RosenbrockND()
    x0 = 0.1 * gmt.init_with_seed(STRESS_CHAINS, STRESS_DIM, STRESS_SEED, device=dev)
    sampler = lambda backend: gmt.HMC(target, x0, STRESS_EPS, STRESS_L, backend=backend)
    reset_counts()
    samples = sampler("cuda").run(STRESS_STEPS, 0)
    torch.cuda.synchronize()
    launches = fused_hmc.wide_launches
    check(launches == 1 and fused_hmc.launches == 0,
          f"hmc-stress: one launch of the wide kernel ({launches})")
    check(tuple(samples.shape) == (STRESS_CHAINS, STRESS_STEPS, STRESS_DIM)
          and bool(torch.isfinite(samples).all()), "hmc-stress: shape, finite")
    t0 = time.perf_counter()
    plain = sampler("torch").run(STRESS_STEPS, 0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(samples, plain), "hmc-stress: backend='cuda' equals backend='torch' bit "
          f"for bit ({int((samples != plain).any(2).any(1).sum())} chains differ)")
    accept = float((samples[:, 1:] != samples[:, :-1]).any(dim=2).float().mean())
    del plain
    ms, wall, _ = timed(lambda: sampler("cuda").run(STRESS_STEPS, 0), 3)
    wide = fused_hmc.wide_map(STRESS_DIM)
    work = target_hmc_work(STRESS_CHAINS, STRESS_DIM, STRESS_STEPS, STRESS_STEPS, STRESS_L,
                           *target_ops("rosenbrock_nd", STRESS_DIM))
    row = dict(ms=round(ms, 4), wall_s=round(wall, 5), launches=launches,
               plain_ms=round(plain_ms, 2), plain_steps=STRESS_STEPS, max_abs_err=0.0,
               accept=round(accept, 4), map=wide,
               shape=f"{STRESS_CHAINS}x{STRESS_DIM}, {STRESS_STEPS} steps x {STRESS_L}",
               **wide_bounds(work, STRESS_CHAINS, wide))
    say("hmc-stress", bit_equal_torch_backend=True, **{k: v for k, v in row.items()})
    return row


def phase_k3_wide(dev):
    """K3-wide: MetropolisHastings(backend="cuda") with the random walk
    2.38/sqrt(d) on the headline's Gaussian at widths 1,000 and 4,096
    (K3_WIDE_CHAINS chains from draws of the target, K3_WIDE_RUN): one
    launch of the wide kernel each, the pooled moments and the accept, the
    R-hat printed; the plain version over the same run, bit for bit; timed."""
    rows = {}
    n_collect, n_discard, thin = K3_WIDE_RUN
    for d in (1000, 4096):
        target, scales = wide_gaussian(d, dev)
        x0 = (gmt.init_with_seed(K3_WIDE_CHAINS, d, SEED, device=dev) * scales.to(dev))
        walk = gmt.RandomWalkProposal(2.38 / math.sqrt(d))
        sampler = lambda: gmt.MetropolisHastings(target, walk, x0, seed=SEED, backend="cuda")
        reset_counts()
        samples = sampler().run(n_collect, n_discard, thin=thin)
        torch.cuda.synchronize()
        launches = fused_mh.wide_launches
        check(launches == 1 and fused_mh.launches == 0,
              f"K3-wide d={d}: one launch of the wide kernel ({launches})")
        store = samples.transpose(0, 1)
        check(tuple(samples.shape) == (K3_WIDE_CHAINS, n_collect, d)
              and bool(torch.isfinite(store).all()), f"K3-wide d={d}: shape, finite")
        rhat, _, mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                     return_moments=True)
        max_rhat = float(rhat.max())
        mean_err = float((mean.cpu() / scales).abs().max())
        sd_err = float((std.cpu() / scales - 1.0).abs().max())
        del rhat, mean, std
        short = sampler().run(WIDE_ACCEPT_STEPS, n_discard)
        accept = float((short[:, 1:] != short[:, :-1]).any(dim=2).float().mean())
        del short
        check(mean_err < WIDE_MOMENT_TOL and sd_err < WIDE_MOMENT_TOL,
              f"K3-wide d={d}: pooled |mean|/scale {mean_err} and |sd/scale - 1| {sd_err} "
              f"< {WIDE_MOMENT_TOL}")
        check(K3_WIDE_ACCEPT[0] < accept < K3_WIDE_ACCEPT[1],
              f"K3-wide d={d}: accept {accept} within {K3_WIDE_ACCEPT}")
        t0 = time.perf_counter()
        want = fused_mh.fused_mh_run_reference(target, x0, walk, n_collect, n_discard,
                                               seed=SEED, thin=thin)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((samples - want).abs().max())
        check(torch.equal(samples, want), f"K3-wide d={d}: the kernel equals its plain version "
              f"bit for bit ({int((samples != want).any(2).any(1).sum())} chains differ)")
        del samples, store, want
        ms, wall, out = timed(lambda: sampler().run(n_collect, n_discard, thin=thin), 3)
        del out
        n_steps = n_discard + n_collect * thin
        wide = fused_mh.wide_map(d)
        # the GaussianND as in "K3-widths": 4 a coordinate and the scale
        work = fused_mh_work(K3_WIDE_CHAINS, d, n_steps, n_collect, 4 * d + 1, MH_PROPOSAL_OPS)
        rows[d] = dict(ms=round(ms, 4), wall_s=round(wall, 5), launches=launches,
                       plain_ms=round(plain_ms, 2), plain_steps=n_steps, max_abs_err=err,
                       accept=round(accept, 4), max_rhat=round(max_rhat, 5),
                       mean_err=round(mean_err, 5), sd_err=round(sd_err, 5), map=wide,
                       steps=n_steps,
                       shape=f"{K3_WIDE_CHAINS}x{d}, {n_discard}+{n_collect}x{thin} steps",
                       **wide_bounds(work, K3_WIDE_CHAINS, wide))
        torch.cuda.empty_cache()
    say("K3-wide", **{str(d): json.dumps(r) for d, r in rows.items()})
    return dict(rows=rows, launches=sum(r["launches"] for r in rows.values()),
                max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def dense_moments(store, scales):
    """max|std/scale - 1| and the mean lag-1 correlation corr(x_i, x_i+1)
    of a steps-major store, pooled, in float64, a million rows at a time."""
    flat = store.reshape(-1, store.shape[-1])
    s1 = torch.zeros(flat.shape[1], dtype=torch.float64, device=flat.device)
    s2, s12 = s1.clone(), s1[:-1].clone()
    for rows in torch.split(flat, 1 << 20):
        r = rows.double()
        s1 += r.sum(0)
        s2 += (r * r).sum(0)
        s12 += (r[:, :-1] * r[:, 1:]).sum(0)
    n = flat.shape[0]
    mean = s1 / n
    var = s2 / n - mean * mean
    corr = (s12 / n - mean[:-1] * mean[1:]) / torch.sqrt(var[:-1] * var[1:])
    std_err = float((torch.sqrt(var).cpu() / scales.double() - 1.0).abs().max())
    return std_err, float(corr.mean())


def dense_k1_checks(target, scales, dev):
    """K1's dense tile kernel against its plain version at DENSE_SMALL_DIMS
    (and the main width) over 8 steps, no chain differing; and a block of
    rows from DENSE_CHAIN0 bit-equal to the launch from 0 at the main
    width."""
    errs = {}
    for d in DENSE_SMALL_DIMS + (DIM,):
        t, sc = (target, scales) if d == DIM else dense_target(d, dev)
        x0 = gmt.init_with_seed(DENSE_SMALL_CHAINS, d, 3, device=dev)
        args, kw = (t, x0, 0.1, 5, 8, 0), dict(seed=11, mass_inv=(sc**2).to(dev))
        errs[d] = compare(fused_hmc.fused_hmc_run(*args, **kw),
                          fused_hmc.fused_hmc_run_reference(*args, **kw),
                          f"K1 dense at d = {d}, {DENSE_SMALL_CHAINS} chains")
    x0 = gmt.init_with_seed(DENSE_CHAIN0 + 300, DIM, 1, device=dev)
    full = fused_hmc.fused_hmc_run(target, x0, 0.1, 5, 6, 2, seed=9)
    rows = slice(DENSE_CHAIN0, DENSE_CHAIN0 + 300)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), 0.1, 5, 6, 2, seed=9,
                                    chain0=DENSE_CHAIN0)
    check(torch.equal(block, full[rows]),
          f"K1 dense: rows from chain {DENSE_CHAIN0} equal the launch from 0 bit for bit")
    return errs


def dense_k3_checks(target, dev):
    """K3's dense tile kernel against its plain version at
    MH_DENSE_SMALL_DIMS over DENSE_EQ_STEPS["K3"] steps from draws of the
    target, with the random walk and with pCN, no chain differing; and a
    block of rows from DENSE_CHAIN0 bit-equal to the launch from 0 at the
    main width, with both proposals."""
    errs = {}
    steps = DENSE_EQ_STEPS["K3"]
    for d in MH_DENSE_SMALL_DIMS:
        t, _ = dense_target(d, dev)
        x0 = (gmt.init_with_seed(DENSE_SMALL_CHAINS, d, 3, device=dev) @ t.chol.mT).contiguous()
        for proposal in (gmt.RandomWalkProposal(0.5 / math.sqrt(d)), gmt.PCNProposal(0.3)):
            args = (t, x0, proposal, steps, 0)
            what = f"K3 dense at d = {d}, {type(proposal).__name__}, {DENSE_SMALL_CHAINS} chains"
            errs[f"{d}_{type(proposal).__name__}"] = compare(
                fused_mh.fused_mh_run(*args, seed=11),
                fused_mh.fused_mh_run_reference(*args, seed=11), what)
    x0 = 0.3 * gmt.init_with_seed(DENSE_CHAIN0 + 300, DIM, 1, device=dev)
    rows = slice(DENSE_CHAIN0, DENSE_CHAIN0 + 300)
    for proposal in (gmt.RandomWalkProposal(DENSE_WALK), gmt.PCNProposal(0.3)):
        full = fused_mh.fused_mh_run(target, x0, proposal, 6, 2, seed=9)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), proposal, 6, 2, seed=9,
                                      chain0=DENSE_CHAIN0)
        check(torch.equal(block, full[rows]),
              f"K3 dense {type(proposal).__name__}: rows from chain {DENSE_CHAIN0} equal the "
              f"launch from 0 bit for bit")
    return errs


def dense_library_ms(target, dev, solve: str) -> float:
    """One PyTorch call that computes a step's solve for the main path's
    chains, on a [DIM, N_CHAINS] residual (float32): Σ⁻¹r by
    ``torch.cholesky_solve`` (K1's gradient) or L⁻¹r by
    ``torch.linalg.solve_triangular`` (K3's density), ms a call.  Timed
    here only; the port never calls them."""
    r = torch.randn((DIM, N_CHAINS), device=dev)
    L = target.chol
    if solve == "cholesky_solve":
        return device_ms(lambda: torch.cholesky_solve(r, L), 20)
    return device_ms(lambda: torch.linalg.solve_triangular(L, r, upper=False), 20)


def tile_bounds(work, solve_flops: float) -> dict:
    """The least times of a dense tile kernel's run: its triangular solves'
    ``solve_flops`` on the CUDA cores in float32 beside the rest of ``work``
    (bytes, float and integer operations), or on the tensor cores as three
    TF32 passes (3 × the flops at the TF32 rate) beside the rest; the bound
    the lesser, and what sets it."""
    n_bytes, rest = work[0], work[1] + work[2]
    figures = {"cuda_core": bound(n_bytes, solve_flops + rest),
               "tensor_3xtf32": max(bound(n_bytes, 3 * solve_flops, TF32_OPS_PER_S),
                                    bound(n_bytes, rest))}
    b_ms, b_by = min(figures.values())
    return dict(bound_ms=round(b_ms, 4), bound_by=b_by,
                **{f"bound_{k}_ms": round(v[0], 4) for k, v in figures.items()})


# The fields of a dense tile kernel's entry in the kernels line.
DENSE_ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_cuda_core_ms",
                  "bound_tensor_3xtf32_ms", "library_ms", "library_call", "registers",
                  "spill_store_bytes", "shared_bytes", "tiles_a_block", "blocks", "accept",
                  "std_err", "corr", "eq_steps", "run_max_abs_err", "run_chains_differ")


def phase_dense_main(dev):
    """The dense GaussianND through K1 (``HMC``: the tile kernel
    ``csrc/fused_hmc_dense.cu``) and K3 (``MetropolisHastings``: the tile
    kernel ``csrc/fused_mh_dense.cu``) at the main path's chains: the
    launches, the moment gates, the kernels against their plain versions over
    a few steps (no chain differing) and over the whole run (reported), timed
    beside one library call a leapfrog or step; both tile kernels also at
    small widths and from chain0, with their launch layouts, registers and
    spills and both bounds (CUDA cores, tensor cores)."""
    target, scales = dense_target(DIM, dev)
    z0 = gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev)
    mass_inv = (scales**2).to(dev)
    out = {}
    small_errs = {"K1": dense_k1_checks(target, scales, dev), "K3": dense_k3_checks(target, dev)}
    for kernel in ("K1", "K3"):
        # K3's chains start from the target (see DENSE_WALK's note)
        x0 = z0 if kernel == "K1" else (z0 @ target.chol.mT).contiguous()
        if kernel == "K1":
            sampler = lambda: gmt.HMC(target, x0, DENSE_EPS, DENSE_L, seed=SEED,
                                      mass_inv=mass_inv, backend="cuda")
            steps, module, lane_module = DENSE_STEPS, fused_hmc_dense, fused_hmc
            plain = lambda c, dsc: fused_hmc.fused_hmc_run_reference(
                target, x0, DENSE_EPS, DENSE_L, c, dsc, seed=SEED, mass_inv=mass_inv)
            run = lambda c, dsc: fused_hmc.fused_hmc_run(target, x0, DENSE_EPS, DENSE_L, c,
                                                         dsc, seed=SEED, mass_inv=mass_inv)
            # the solves, d (d + 1) multiply-adds a leapfrog, apart from the
            # rest (the density's squares and the gradient's sign: 2 d each);
            # the kernel runs its panels in three TF32 passes
            solve_flops = N_CHAINS * sum(steps) * DENSE_L * 2 * DIM * (DIM + 1)
            work = target_hmc_work(N_CHAINS, DIM, sum(steps), steps[0], DENSE_L, 2 * DIM,
                                   2 * DIM)
            bounds = tile_bounds(work, solve_flops)
            library = dense_library_ms(target, dev, "cholesky_solve") * sum(steps) * DENSE_L
            library_call = "torch.cholesky_solve of the [100, 10240] residual x 12,000"
            layout = fused_hmc_dense.launch_layout(N_CHAINS, DIM)
            build = build_report(dense_build(DIM), f"fused_hmc_dense_kernel<{-(-DIM // 8)}>")
        else:
            walk = gmt.RandomWalkProposal(DENSE_WALK)
            sampler = lambda: gmt.MetropolisHastings(target, walk, x0, seed=SEED,
                                                     backend="cuda")
            steps, module, lane_module = DENSE_MH_STEPS, fused_mh_dense, fused_mh
            plain = lambda c, dsc: fused_mh.fused_mh_run_reference(target, x0, walk, c, dsc,
                                                                   seed=SEED)
            run = lambda c, dsc: fused_mh.fused_mh_run(target, x0, walk, c, dsc, seed=SEED)
            # the forward solve, d (d + 1) flops a step, apart from the rest
            # (the residual, the squares and their sum: 3 d); the kernel runs
            # it in float32 on the CUDA cores
            solve_flops = N_CHAINS * sum(steps) * DIM * (DIM + 1)
            work = fused_mh_work(N_CHAINS, DIM, sum(steps), steps[0], 3 * DIM, MH_PROPOSAL_OPS)
            bounds = tile_bounds(work, solve_flops)
            library = dense_library_ms(target, dev, "solve_triangular") * sum(steps)
            library_call = "torch.linalg.solve_triangular a step x 2,500"
            layout = fused_mh_dense.launch_layout(N_CHAINS, DIM)
            # the random walk's instantiation
            build = build_report(dense_build(DIM, "fused_mh_dense"), "fused_mh_dense_kernel<0>")
        reset_counts()
        samples = sampler().run(*steps)
        torch.cuda.synchronize()
        launches = module.launches
        check(launches == 1 and lane_module.launches == 0,
              f"one {kernel} tile launch on the dense GaussianND ({launches}; {kernel}'s lane "
              f"kernel {lane_module.launches})")
        store = samples.transpose(0, 1)
        check(bool(torch.isfinite(store).all()), f"{kernel} dense samples are finite")
        accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())
        std_err, corr = dense_moments(store, scales)
        tol = DENSE_TOL[kernel]
        check(std_err < tol and abs(corr - 0.5) < tol,
              f"{kernel} dense: max|std/scale - 1| {std_err} < {tol}, lag-1 correlation "
              f"{corr} within {tol} of 0.5")
        if kernel == "K1":
            check(0.6 < accept < 0.95, f"K1 dense accept {accept} within 0.6-0.95")
        eq = DENSE_EQ_STEPS[kernel]
        gate = {}
        if kernel == "K1":
            eq_err = compare(run(eq, 0), plain(eq, 0), f"{kernel} dense over {eq} steps")
        else:
            # K3: its chains off the float64 plain version over KL_OFF_SEEDS
            # at KL_OFF_STEPS steps at most the float32 plain version's own
            # + KL_OFF_SLACK (the logistic kernels' rule); the error over the
            # chains whose accept histories agree
            got, want = run(eq, 0), plain(eq, 0)
            same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
            eq_err = float((got[same] - want[same]).abs().max())
            gate["eq_chains_differ"] = int((~same).sum())
            del got, want
            target64 = target.to(dtype=torch.float64)
            gate["off_f64_kernel"], gate["off_f64_plain_f32"] = chains_off(
                lambda seed: fused_mh.fused_mh_run(target, x0, walk, KL_OFF_STEPS, 0, seed=seed),
                lambda seed: fused_mh.fused_mh_run_reference(target, x0, walk, KL_OFF_STEPS, 0,
                                                             seed=seed),
                lambda seed: fused_mh.fused_mh_run_reference(target64, x0.double(), walk,
                                                             KL_OFF_STEPS, 0, seed=seed), x0)
            del target64
        # the whole run's plain version, compared and timed
        t0 = time.perf_counter()
        want = plain(*steps)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        close = torch.isclose(samples, want, rtol=K1_RTOL, atol=K1_ATOL)
        run_differ = int((~close).reshape(N_CHAINS, -1).any(dim=1).sum())
        run_err = float((samples - want).abs().max())
        del samples, store, want, close
        ms, _, o = timed(lambda: sampler().run(*steps), 3)
        del o
        # the layout of the run's launch, from the kernel's host code
        out[kernel] = dict(launches=launches, accept=round(accept, 4),
                           std_err=round(std_err, 5), corr=round(corr, 5),
                           eq_steps=eq, eq_max_abs_err=eq_err, run_max_abs_err=run_err,
                           run_chains_differ=run_differ, ms=round(ms, 3),
                           plain_ms=round(plain_ms, 1), library_ms=round(library, 3),
                           library_call=library_call, **bounds,
                           small_max_abs_err=small_errs[kernel], chain0_bit_equal=True, **gate,
                           **{k: v for k, v in layout.items() if k != "tiles"}, **build)
    say("dense-main", chains=N_CHAINS, dim=DIM, k1=f"eps {DENSE_EPS} L {DENSE_L} "
        f"{DENSE_STEPS[1]}+{DENSE_STEPS[0]}", k3=f"walk {DENSE_WALK} "
        f"{DENSE_MH_STEPS[1]}+{DENSE_MH_STEPS[0]}", max_dense_dim_k1=fused_hmc.MAX_DENSE_DIM,
        max_dense_dim_k3=fused_mh.MAX_DENSE_DIM, results=json.dumps(out))
    return out


def two_figures_down(x: float) -> float:
    """``x`` rounded down to two significant figures."""
    scale = 10.0 ** (math.floor(math.log10(abs(x))) - 1)
    return math.floor(x / scale) * scale


def accept_history(samples, x0):
    """[n, steps] bool: whether each step moved its chain."""
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


def phase_k1_logistic(dev, chees: dict):
    """``HMC(backend="cuda")`` on the stretch line's posterior at full width
    (one launch of ``csrc/fused_hmc_logistic.cu``): accept, R-hat, the
    posterior against "chees-logistic"'s; the kernel against its plain
    version at 1, 8 and 64 steps (and the plain version in float32 against
    itself in float64, for scale); timed beside the plain version and the
    two ``torch.matmul`` of a leapfrog."""
    X, y, _ = bench_logistic_data(device=dev)
    target = gmt.HierarchicalLogisticNC(X, y)
    mass_inv = chees["mass_inv"].to(dev)
    x0 = (0.1 * gmt.init_with_seed(N_CHAINS, LGC_DIM, SEED, device=dev)).contiguous()
    sampler = lambda e: gmt.HMC(target, x0, e, LGH_L, seed=SEED, mass_inv=mass_inv,
                                backend="cuda")
    rounded = two_figures_down(chees["eps_bar"])
    s = sampler(rounded).run(*LGH_ROUNDED_STEPS).transpose(0, 1)
    rounded_accept = float((s[1:] != s[:-1]).any(dim=2).float().mean())
    del s
    eps = LGH_EPS
    reset_counts()
    samples = sampler(eps).run(*LGH_STEPS)
    torch.cuda.synchronize()
    launches, k1_launches = fused_hmc_logistic.launches, fused_hmc.launches
    check(launches == 1 and k1_launches == 0,
          f"one logistic HMC launch on its path ({launches}; K1 {k1_launches})")
    store = samples.transpose(0, 1)
    check(tuple(samples.shape) == (N_CHAINS, LGH_STEPS[0], LGC_DIM)
          and bool(torch.isfinite(store).all()), "logistic HMC samples: shape and finite")
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(store, steps_major=True, return_moments=True)
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    ref_mean, ref_std = chees["mean"].float(), chees["std"].float()
    mean_dev = float(((mean.cpu() - ref_mean).abs() / ref_std).max())
    sd_dev = float((std.cpu() / ref_std - 1.0).abs().max())
    check(0.6 < accept < 0.95, f"logistic HMC accept {accept} within 0.6-0.95")
    check(max_rhat < 1.01, f"logistic HMC max R-hat {max_rhat} < 1.01")
    check(mean_dev < LGH_MEAN_SD and sd_dev < LGH_SD_REL,
          f"logistic HMC posterior: means within {mean_dev} < {LGH_MEAN_SD} sd of "
          f"chees-logistic's, sds within {sd_dev} < {LGH_SD_REL}")
    del samples, store

    # the kernel against its plain version, over the chains whose accept
    # decisions agree; the plain version in float32 against float64
    rel, differ, rel64, abs_err = {}, {}, {}, 0.0
    for steps in LGH_EQ_STEPS:
        args = (target, x0, eps, LGH_L, steps, 0)
        got = fused_hmc.fused_hmc_run(*args, seed=SEED, mass_inv=mass_inv)
        want = fused_hmc.fused_hmc_run_reference(*args, seed=SEED, mass_inv=mass_inv)
        same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
        differ[steps] = int((~same).sum())
        rel[steps] = float((got[same] - want[same]).abs().max() / want[same].abs().max())
        abs_err = max(abs_err, float((got[same] - want[same]).abs().max()))
        want64 = fused_hmc.fused_hmc_run_reference(target.to(dtype=torch.float64),
                                                   x0.double(), eps, LGH_L, steps, 0,
                                                   seed=SEED, mass_inv=mass_inv.double())
        same64 = (accept_history(want64, x0.double()) == accept_history(want, x0)).all(dim=1)
        rel64[steps] = float((want[same64].double() - want64[same64]).abs().max()
                             / want64[same64].abs().max())
        del got, want, want64
    say("K1-logistic-agreement", eps=eps, **{f"rel_err_{k}": f"{v:.3e}" for k, v in rel.items()},
        **{f"chains_differ_{k}": v for k, v in differ.items()},
        **{f"plain_f32_vs_f64_rel_{k}": f"{v:.3e}" for k, v in rel64.items()})
    for steps in LGH_EQ_STEPS:
        check(rel[steps] < LGH_RTOL, f"logistic HMC after {steps} steps: relative error "
              f"{rel[steps]} < {LGH_RTOL}")

    ms, wall, o = timed(lambda: sampler(eps).run(*LGH_STEPS), 3)
    del o
    t0 = time.perf_counter()
    o = fused_hmc.fused_hmc_run_reference(target, x0, eps, LGH_L, *LGH_STEPS, seed=SEED,
                                          mass_inv=mass_inv)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del o
    # the yardstick: the two torch.matmul of one leapfrog alone, times the
    # run's leapfrogs
    n_steps = sum(LGH_STEPS)
    leapfrogs = n_steps * LGH_L
    p = X.shape[1]
    library_ms = library_matmul_ms(dev, [((N_CHAINS, p), (p, LGC_OBS)),
                                         ((N_CHAINS, LGC_OBS), (LGC_OBS, p))], leapfrogs)
    # the bound: the algorithm's gradients (L a step) in three TF32 passes on
    # the tensor cores, beside the other operations on the CUDA cores (K4's
    # per gradient, a softplus and its sum an observation at the last
    # position of a step); the state and X read once, the store written once
    n_bytes = 4 * (N_CHAINS * LGC_DIM * (1 + LGH_STEPS[0]) + LGC_OBS * p + LGC_OBS)
    flops = N_CHAINS * leapfrogs * 4 * LGC_OBS * p
    other = N_CHAINS * (leapfrogs * (8 * LGC_OBS + 8 * p) + n_steps * 20 * LGC_OBS)
    b_ms = max(bound(n_bytes, 3 * flops, TF32_OPS_PER_S)[0], bound(n_bytes, other)[0])
    cuda_core_ms = bound(n_bytes, flops + other)[0]
    # the layout of the run's launch, from the kernel's host code
    layout = fused_hmc_logistic.launch_layout(N_CHAINS, LGC_OBS, p)
    build = build_report(logistic_hmc_build(p), "fused_hmc_logistic_kernel<6,0>")
    say("K1-logistic", chains=N_CHAINS, dim=LGC_DIM, n_obs=LGC_OBS, eps=eps,
        eps_bar=f"{chees['eps_bar']:.6f}", eps_bar_rounded=rounded,
        rounded_accept=f"{rounded_accept:.4f}",
        rounded_steps=f"{LGH_ROUNDED_STEPS[1]}+{LGH_ROUNDED_STEPS[0]}",
        L=LGH_L, steps=f"{LGH_STEPS[1]}+{LGH_STEPS[0]}",
        launches=launches, accept=f"{accept:.4f}", max_rhat=f"{max_rhat:.5f}",
        min_ess=f"{min_ess:.1f}", mean_dev_sd=f"{mean_dev:.4f}", sd_dev=f"{sd_dev:.4f}",
        kernel_ms=f"{ms:.3f}", wall_s=f"{wall:.5f}",
        grad_evals_per_s=f"{N_CHAINS * leapfrogs / wall:.4e}",
        min_ess_per_s=f"{min_ess / wall:.4e}", plain_ms=f"{plain_ms:.1f}",
        bound_ms=f"{b_ms:.3f}", bound_by="operations", bound_cuda_core_ms=f"{cuda_core_ms:.3f}",
        library_ms=f"{library_ms:.3f}", tflops=f"{flops / (ms * 1e-3) / 1e12:.3f}",
        tiles_a_block=layout["tiles_a_block"], blocks=layout["blocks"],
        sms=torch.cuda.get_device_properties(0).multi_processor_count, **build)
    return dict(launches=launches, rel_err=rel, chains_differ=differ, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_cuda_core_ms=cuda_core_ms, library_ms=library_ms,
                max_abs_err=abs_err, accept=accept, eps=eps,
                shared_bytes=layout["shared_bytes"], tiles_a_block=layout["tiles_a_block"],
                blocks=layout["blocks"], **build)


def logistic_posterior(dev, chees: dict, centred: bool):
    """The stretch line's posterior in one parameterisation: the target, the
    chains' start (``chees-logistic``'s last draws, mapped to (mu, log tau,
    beta) for the centred target) and the reference mean and sd."""
    X, y, _ = bench_logistic_data(device=dev)
    nc = gmt.HierarchicalLogisticNC(X, y)
    last = chees["last"].to(dev)
    if not centred:
        return nc, last, chees["mean"].float(), chees["std"].float()
    x0 = torch.cat([last[:, :2], nc.beta(last)], dim=1).contiguous()
    return (gmt.HierarchicalLogistic(X, y), x0, chees["mapped_mean"].float(),
            chees["mapped_std"].float())


def posterior_deviations(mean, std, ref_mean, ref_std):
    """Per coordinate |mean - ref| / ref sd and |sd / ref sd - 1|."""
    return ((mean.cpu() - ref_mean).abs() / ref_std, (std.cpu() / ref_std - 1.0).abs())


def chains_off(run, plain, plain64, x0, what: str = ""):
    """Over KL_OFF_SEEDS at KL_OFF_STEPS steps: the chains whose accept
    histories differ from the float64 plain version's, the kernel's
    (``run(seed)``) and the float32 plain version's (``plain(seed)``), a
    count per seed each; the kernel's at most the float32 plain version's +
    KL_OFF_SLACK (``what`` names the check)."""
    kernel_off, plain_off = [], []
    for seed in KL_OFF_SEEDS:
        h64 = accept_history(plain64(seed), x0.double())
        kernel_off.append(int((accept_history(run(seed), x0) != h64).any(dim=1).sum()))
        plain_off.append(int((accept_history(plain(seed), x0) != h64).any(dim=1).sum()))
    check(sum(kernel_off) <= sum(plain_off) + KL_OFF_SLACK,
          f"{what}chains off the float64 plain version over seeds {KL_OFF_SEEDS}: the kernel's "
          f"{kernel_off} at most the float32 plain version's {plain_off} + {KL_OFF_SLACK}")
    return kernel_off, plain_off


def phase_k3_logistic(dev, chees: dict, centred: bool, library_ms=None):
    """``MetropolisHastings(backend="cuda")`` on the stretch line's posterior
    (one launch of ``csrc/fused_mh_logistic.cu``, none of
    ``csrc/fused_mh.cu``): accept; R-hat and the posterior against
    "chees-logistic"'s on a thinned run (KL_THIN); the kernel against its
    plain version, bit-equal on the chains whose accept histories agree
    (the random walk, and pCN at KL_PCN_CHAINS), and its chains off the
    float64 plain version against the float32 plain version's own; timed
    beside the plain version, one ``torch.matmul`` a step and the bound.
    The matmul's time (the forward product alone, not a call that computes
    the MH step) is taken once, between two timings of the kernel, where
    ``library_ms`` is None, and that one figure serves both targets."""
    label = "K3-logistic-centred" if centred else "K3-logistic"
    target, x0, ref_mean, ref_std = logistic_posterior(dev, chees, centred)
    n, d = x0.shape
    n_obs, p = target.X.shape
    scale = two_figures_down(2.38 / math.sqrt(d) * float(ref_std.min()))
    walk = gmt.RandomWalkProposal(scale)
    sampler = lambda: gmt.MetropolisHastings(target, walk, x0, seed=SEED, backend="cuda")
    reset_counts()
    samples = sampler().run(*KL_STEPS)
    torch.cuda.synchronize()
    launches, lane_launches = fused_mh_logistic.launches, fused_mh.launches
    check(launches == 1 and lane_launches == 0,
          f"{label}: one logistic MH launch ({launches}; fused_mh.cu {lane_launches})")
    store = samples.transpose(0, 1)
    check(tuple(samples.shape) == (n, KL_STEPS[0], d) and bool(torch.isfinite(store).all()),
          f"{label}: shape and finite")
    accept = moved_share(samples)
    check(KL_ACCEPT[0] < accept < KL_ACCEPT[1], f"{label}: accept {accept} within {KL_ACCEPT}")
    unthinned_rhat = float(gmt.split_rhat_mean_ess(store, steps_major=True)[0].max())
    del samples, store
    # the gate run, thinned
    gate = sampler().run(*KL_STEPS, thin=KL_THIN)
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(gate.transpose(0, 1), steps_major=True,
                                                   return_moments=True)
    del gate
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    mean_dev, sd_dev = posterior_deviations(mean, std, ref_mean, ref_std)
    check(max_rhat < 1.01, f"{label}: max R-hat {max_rhat} < 1.01 (thin {KL_THIN})")
    check(float(mean_dev.max()) < LGH_MEAN_SD and float(sd_dev.max()) < LGH_SD_REL,
          f"{label}: means within {float(mean_dev.max())} < {LGH_MEAN_SD} sd of "
          f"chees-logistic's, sds within {float(sd_dev.max())} < {LGH_SD_REL}")

    # the kernel against its plain version: bit-equal where the accept
    # histories agree
    differ, equal_rows = {}, 0
    pcn = gmt.PCNProposal(KL_PCN)
    for name, prop, xs in (("walk", walk, x0), ("pcn", pcn, x0[:KL_PCN_CHAINS].contiguous())):
        for steps in KL_EQ_STEPS:
            got = fused_mh.fused_mh_run(target, xs, prop, steps, 0, seed=SEED)
            want = fused_mh.fused_mh_run_reference(target, xs, prop, steps, 0, seed=SEED)
            same = (accept_history(got, xs) == accept_history(want, xs)).all(dim=1)
            check(torch.equal(got[same], want[same]),
                  f"{label} {name}: the chains whose accept histories agree are bit-equal "
                  f"after {steps} steps")
            differ[f"{name}_{steps}"] = int((~same).sum())
            equal_rows += int(same.sum())
    target64 = target.to(dtype=torch.float64)
    kernel_off, plain_off = chains_off(
        lambda seed: fused_mh.fused_mh_run(target, x0, walk, KL_OFF_STEPS, 0, seed=seed),
        lambda seed: fused_mh.fused_mh_run_reference(target, x0, walk, KL_OFF_STEPS, 0,
                                                     seed=seed),
        lambda seed: fused_mh.fused_mh_run_reference(target64, x0.double(), walk,
                                                     KL_OFF_STEPS, 0, seed=seed), x0)

    ms, wall, o = timed(lambda: sampler().run(*KL_STEPS), 3)
    del o
    n_steps = sum(KL_STEPS)
    ms_after = None
    if library_ms is None:
        library_ms = library_matmul_ms(dev, [((n, p), (p, n_obs))], n_steps)
        ms_after, _, o = timed(lambda: sampler().run(*KL_STEPS), 1)
        del o
    t0 = time.perf_counter()
    o = fused_mh.fused_mh_run_reference(target, x0, walk, *KL_STEPS, seed=SEED)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del o
    # the bound: the run's products (2 n_obs p flops a chain and step) in
    # three TF32 passes on the tensor cores, beside ~20 operations an
    # observation for the softplus and its sum on the CUDA cores; the state
    # and X read once, the store written once
    n_bytes = 4 * (n * d * (1 + KL_STEPS[0]) + n_obs * p + n_obs)
    flops = n * n_steps * 2 * n_obs * p
    other = n * n_steps * 20 * n_obs
    b_ms = max(bound(n_bytes, 3 * flops, TF32_OPS_PER_S)[0], bound(n_bytes, other)[0])
    cuda_core_ms = bound(n_bytes, flops + other)[0]
    layout = fused_mh_logistic.launch_layout(n, n_obs, p)
    # the softplus's error in float32 against float64 on the logits of the
    # chains' start: the plain version's F.softplus, which calls the device
    # functions the kernel calls (expf, log1pf) past the same threshold
    beta64 = x0.double()[:, 2:] if centred else (
        x0.double()[:, :1] + torch.exp(x0.double()[:, 1:2]) * x0.double()[:, 2:])
    logits = beta64 @ target.X.double().T
    sp_err = float((F.softplus(logits.float()).double() - F.softplus(logits)).abs().max())
    del beta64, logits
    # the random walk's instantiation
    build = build_report(logistic_mh_build(p), f"fused_mh_logistic_kernel<0,{int(centred)}>")
    say(label, chains=n, dim=d, n_obs=n_obs, walk=scale,
        least_sd=f"{float(ref_std.min()):.6f}", steps=f"{KL_STEPS[1]}+{KL_STEPS[0]}",
        launches=launches, accept=f"{accept:.4f}", unthinned_max_rhat=f"{unthinned_rhat:.5f}",
        thin=KL_THIN, max_rhat=f"{max_rhat:.5f}",
        min_ess=f"{min_ess:.1f}", mean_dev_sd=f"{float(mean_dev.max()):.4f}",
        sd_dev=f"{float(sd_dev.max()):.4f}", chains_differ=json.dumps(differ),
        equal_rows=equal_rows, off_f64_kernel=json.dumps(kernel_off),
        off_f64_plain_f32=json.dumps(plain_off), kernel_ms=f"{ms:.3f}", wall_s=f"{wall:.5f}",
        samples_per_s=f"{n * KL_STEPS[0] / wall:.4e}", plain_ms=f"{plain_ms:.1f}",
        bound_ms=f"{b_ms:.3f}", bound_by="operations", bound_cuda_core_ms=f"{cuda_core_ms:.3f}",
        library_ms=f"{library_ms:.3f}", kernel_ms_after_library=ms_after,
        tflops=f"{flops / (ms * 1e-3) / 1e12:.3f}", softplus_f32_max_abs_err=f"{sp_err:.3e}",
        **{k: v for k, v in layout.items() if k != "tiles"}, **build)
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_cuda_core_ms=cuda_core_ms, library_ms=library_ms, accept=accept,
                max_rhat=max_rhat, walk=scale, chains_differ=differ, off_f64_kernel=kernel_off,
                off_f64_plain_f32=plain_off, layout=layout, **build)


def phase_k1_logistic_centred(dev, chees: dict):
    """``HMC(backend="cuda")`` on the centred stretch-line posterior (one
    launch of ``csrc/fused_hmc_logistic.cu``, none of ``csrc/fused_hmc.cu``)
    in the metric of "chees-logistic"'s mapped draws: accept, R-hat, the
    posterior against the mapped reference; the kernel against its plain
    version after 1, 8 and 64 steps over the chains whose accept histories
    agree, and its chains off the float64 plain version against the float32
    plain version's own; timed as "K1-logistic"."""
    target, _, ref_mean, ref_std = logistic_posterior(dev, chees, True)
    n_obs, p = target.X.shape
    mass_inv = (ref_std**2).to(dev)
    x0 = (0.1 * gmt.init_with_seed(N_CHAINS, LGC_DIM, SEED, device=dev)).contiguous()
    eps = LGHC_EPS
    sampler = lambda: gmt.HMC(target, x0, eps, LGH_L, seed=SEED, mass_inv=mass_inv,
                              backend="cuda")
    reset_counts()
    samples = sampler().run(*LGH_STEPS)
    torch.cuda.synchronize()
    launches, k1_launches = fused_hmc_logistic.launches, fused_hmc.launches
    check(launches == 1 and k1_launches == 0,
          f"one centred logistic HMC launch ({launches}; K1 {k1_launches})")
    store = samples.transpose(0, 1)
    check(tuple(samples.shape) == (N_CHAINS, LGH_STEPS[0], LGC_DIM)
          and bool(torch.isfinite(store).all()), "centred logistic HMC: shape and finite")
    accept = moved_share(samples)
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(store, steps_major=True, return_moments=True)
    del samples, store
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    mean_dev, sd_dev = posterior_deviations(mean, std, ref_mean, ref_std)
    check(0.6 < accept < 0.95, f"centred logistic HMC accept {accept} within 0.6-0.95")
    check(max_rhat < 1.01, f"centred logistic HMC max R-hat {max_rhat} < 1.01")
    beta_dev = (float(mean_dev[2:].max()), float(sd_dev[2:].max()))
    hyper_dev = (float(mean_dev[:2].max()), float(sd_dev[:2].max()))
    check(beta_dev[0] < LGH_MEAN_SD and beta_dev[1] < LGH_SD_REL,
          f"centred logistic HMC: beta's means within {beta_dev[0]} < {LGH_MEAN_SD} sd, sds "
          f"within {beta_dev[1]} < {LGH_SD_REL} of the mapped reference")
    check(hyper_dev[0] < LGHC_HYPER[0] and hyper_dev[1] < LGHC_HYPER[1],
          f"centred logistic HMC: mu's and log tau's means within {hyper_dev[0]} < "
          f"{LGHC_HYPER[0]} sd, sds within {hyper_dev[1]} < {LGHC_HYPER[1]}")

    # the kernel against its plain version, over the chains whose accept
    # decisions agree; the plain version in float32 against float64
    kw = dict(seed=SEED, mass_inv=mass_inv)
    target64, x64, m64 = target.to(dtype=torch.float64), x0.double(), mass_inv.double()
    rel, differ, rel64, abs_err = {}, {}, {}, 0.0
    for steps in LGH_EQ_STEPS:
        args = (target, x0, eps, LGH_L, steps, 0)
        got = fused_hmc.fused_hmc_run(*args, **kw)
        want = fused_hmc.fused_hmc_run_reference(*args, **kw)
        same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
        differ[steps] = int((~same).sum())
        rel[steps] = float((got[same] - want[same]).abs().max() / want[same].abs().max())
        abs_err = max(abs_err, float((got[same] - want[same]).abs().max()))
        want64 = fused_hmc.fused_hmc_run_reference(target64, x64, eps, LGH_L, steps, 0,
                                                   seed=SEED, mass_inv=m64)
        same64 = (accept_history(want64, x64) == accept_history(want, x0)).all(dim=1)
        rel64[steps] = float((want[same64].double() - want64[same64]).abs().max()
                             / want64[same64].abs().max())
        del got, want, want64
    say("K1-logistic-centred-agreement", eps=eps,
        **{f"rel_err_{k}": f"{v:.3e}" for k, v in rel.items()},
        **{f"chains_differ_{k}": v for k, v in differ.items()},
        **{f"plain_f32_vs_f64_rel_{k}": f"{v:.3e}" for k, v in rel64.items()})
    for steps in LGH_EQ_STEPS:
        check(rel[steps] < LGH_RTOL, f"centred logistic HMC after {steps} steps: relative "
              f"error {rel[steps]} < {LGH_RTOL}")
    kernel_off, plain_off = chains_off(
        lambda seed: fused_hmc.fused_hmc_run(target, x0, eps, LGH_L, KL_OFF_STEPS, 0,
                                             seed=seed, mass_inv=mass_inv),
        lambda seed: fused_hmc.fused_hmc_run_reference(target, x0, eps, LGH_L, KL_OFF_STEPS,
                                                       0, seed=seed, mass_inv=mass_inv),
        lambda seed: fused_hmc.fused_hmc_run_reference(target64, x64, eps, LGH_L,
                                                       KL_OFF_STEPS, 0, seed=seed,
                                                       mass_inv=m64), x0)

    ms, wall, o = timed(lambda: sampler().run(*LGH_STEPS), 3)
    del o
    t0 = time.perf_counter()
    o = fused_hmc.fused_hmc_run_reference(target, x0, eps, LGH_L, *LGH_STEPS, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del o
    n_steps = sum(LGH_STEPS)
    leapfrogs = n_steps * LGH_L
    library_ms = library_matmul_ms(dev, [((N_CHAINS, p), (p, n_obs)),
                                         ((N_CHAINS, n_obs), (n_obs, p))], leapfrogs)
    # the bound: "K1-logistic"'s, the same shapes and work
    n_bytes = 4 * (N_CHAINS * LGC_DIM * (1 + LGH_STEPS[0]) + n_obs * p + n_obs)
    flops = N_CHAINS * leapfrogs * 4 * n_obs * p
    other = N_CHAINS * (leapfrogs * (8 * n_obs + 8 * p) + n_steps * 20 * n_obs)
    b_ms = max(bound(n_bytes, 3 * flops, TF32_OPS_PER_S)[0], bound(n_bytes, other)[0])
    cuda_core_ms = bound(n_bytes, flops + other)[0]
    build = build_report(logistic_hmc_build(p), "fused_hmc_logistic_kernel<6,1>")
    say("K1-logistic-centred", chains=N_CHAINS, dim=LGC_DIM, n_obs=n_obs, eps=eps, L=LGH_L,
        steps=f"{LGH_STEPS[1]}+{LGH_STEPS[0]}", launches=launches, accept=f"{accept:.4f}",
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}",
        beta_mean_dev_sd=f"{beta_dev[0]:.4f}", beta_sd_dev=f"{beta_dev[1]:.4f}",
        mu_mean_dev_sd=f"{float(mean_dev[0]):.4f}", mu_sd_dev=f"{float(sd_dev[0]):.4f}",
        log_tau_mean_dev_sd=f"{float(mean_dev[1]):.4f}",
        log_tau_sd_dev=f"{float(sd_dev[1]):.4f}",
        off_f64_kernel=json.dumps(kernel_off), off_f64_plain_f32=json.dumps(plain_off),
        kernel_ms=f"{ms:.3f}", wall_s=f"{wall:.5f}",
        grad_evals_per_s=f"{N_CHAINS * leapfrogs / wall:.4e}",
        min_ess_per_s=f"{min_ess / wall:.4e}", plain_ms=f"{plain_ms:.1f}",
        bound_ms=f"{b_ms:.3f}", bound_by="operations", bound_cuda_core_ms=f"{cuda_core_ms:.3f}",
        library_ms=f"{library_ms:.3f}", tflops=f"{flops / (ms * 1e-3) / 1e12:.3f}", **build)
    return dict(launches=launches, rel_err=rel, chains_differ=differ, max_abs_err=abs_err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_cuda_core_ms=cuda_core_ms,
                library_ms=library_ms, accept=accept, eps=eps, off_f64_kernel=kernel_off,
                off_f64_plain_f32=plain_off, **build)


def german_posterior(dev):
    """German credit's shape (LGG_OBS x LGG_FEATURES, data at LGG_SEED) and
    its posterior by ChEES on the non-centred target at the main path's
    chains: the two targets, ChEES's ε̄ and metric (the centred target's the
    mapped draws' variance), its last draws (mapped to (mu, log tau, beta)
    for the centred target) and their mean and sd, each parameterisation's
    reference; beside them, the largest ratio of the pooled collection's sd
    to the last draws' (the in-run statistics', and the mapped draws'), and
    where the excess lies: each quarter of the collection's mapped spread
    against the last draws', the draws past LGG_FAR of the last draws' sds
    in some mapped coordinate (their count, chains, steps and log density
    against the median draw's), and the collection's divergences."""
    X, y, _ = gmt.make_logistic_data(LGG_SEED, LGG_OBS, LGG_FEATURES, device=dev)
    nc = gmt.HierarchicalLogisticNC(X, y)
    d = LGG_FEATURES + 2
    sampler = gmt.ChEESHMC(nc, gmt.init_with_seed(N_CHAINS, d, SEED, device=dev),
                           target_accept_p=LGC_ACCEPT, jitter_amount=LGC_JITTER,
                           static_collection=True, seed=SEED, device=dev)
    t0 = time.perf_counter()
    draws = sampler.run(LGG_COLLECT, LGG_WARMUP, with_stats=True)
    torch.cuda.synchronize()
    chees_s = time.perf_counter() - t0
    check(bool(torch.isfinite(draws).all()), "German credit's ChEES draws are finite")
    rhat, _, _, pooled_std = gmt.combine_suffstats_host(*sampler._suffstats)
    max_rhat = float(np.max(rhat))
    check(max_rhat < 1.01, f"German credit's ChEES max R-hat {max_rhat} < 1.01")
    last = draws[:, -1].contiguous()
    mapped = torch.cat([last[:, :2], nc.beta(last)], dim=1).contiguous()
    moments = lambda x: (x.double().mean(0).float().cpu(), x.double().std(0).float().cpu())
    nc_ref, centred_ref = moments(last), moments(mapped)
    ref_mean, ref_std = (r.to(dev).double() for r in centred_ref)
    # the pooled collection's mapped spreads, by quarter of the collection,
    # from the draws in float64, a block of chains at a time; the draws far
    # from the last draws' moments, with their log densities
    quarters = draws.shape[1] // 4
    s1 = torch.zeros(4, d, dtype=torch.float64, device=dev)
    s2 = s1.clone()
    far_chains, far_steps, far_lp = [], [], []
    for i, rows in enumerate(torch.split(draws, 1024)):
        m = torch.cat([rows[..., :2], nc.beta(rows)], dim=-1).double()
        q = m.reshape(m.shape[0], 4, quarters, d)
        s1 += q.sum(dim=(0, 2))
        s2 += (q * q).sum(dim=(0, 2))
        far = (((m - ref_mean) / ref_std).abs().amax(dim=-1) > LGG_FAR).nonzero()
        far_chains.append(far[:, 0] + 1024 * i)
        far_steps.append(far[:, 1])
        far_lp.append(nc.unnorm_logp(rows[far[:, 0], far[:, 1]]))
    count = draws.shape[0] * quarters
    quarter_std = torch.sqrt(s2 / count - (s1 / count) ** 2)
    pooled_mapped_std = torch.sqrt(s2.sum(0) / (4 * count) - (s1.sum(0) / (4 * count)) ** 2)
    median_lp = float(nc.unnorm_logp(last).median())
    far_chains, far_steps, far_lp = (torch.cat(v).cpu() for v in (far_chains, far_steps, far_lp))
    del draws
    per_chain = sampler.divergences.cpu()
    diverging = set(torch.nonzero(per_chain > 0).flatten().tolist())
    far_set = set(far_chains.tolist())
    chees = dict(eps_bar=float(sampler.adapted_step_size), chees_s=chees_s, max_rhat=max_rhat,
                 pooled_over_last_sd=round(float((torch.as_tensor(pooled_std).float()
                                                  / nc_ref[1]).max()), 4),
                 pooled_over_last_mapped_sd=round(float((pooled_mapped_std.float().cpu()
                                                         / centred_ref[1]).max()), 4),
                 quarter_over_last_mapped_sd=[round(float(v), 4) for v in
                                              (quarter_std / ref_std).amax(dim=1)],
                 far_draws=int(far_chains.numel()), far_chains=len(far_set),
                 far_steps=[int(far_steps.min()), int(far_steps.max())] if far_set else [],
                 far_lp_below_median=(round(median_lp - float(far_lp.max()), 2),
                                      round(median_lp - float(far_lp.min()), 2))
                 if far_set else (), divergences=int(per_chain.sum()),
                 chains_diverging=len(diverging), far_chains_diverging=len(far_set & diverging))
    return chees, {
        "nc": (nc, sampler.adapted_mass_inv.float(), last, *nc_ref),
        "centred": (gmt.HierarchicalLogistic(X, y), (centred_ref[1]**2).to(dev), mapped,
                    *centred_ref)}


def x_bytes_read(layout: dict, densities: int) -> int:
    """The bytes of X (its hi and lo and y) the blocks of a launch read over
    a run of ``densities`` passes over the data (gradients or log
    densities) a tile: the streamed path's split copy once a block and
    pass, the resident path's X once a block."""
    if layout["streamed"]:
        return 4 * layout["blocks"] * densities * layout["scratch_words"]
    return layout["blocks"] * layout["shared_bytes"]


def spill_free(build: dict, what: str) -> None:
    """A build this run compiled spills nothing (ptxas -v)."""
    check(build["spill_store_bytes"] in (0, None),
          f"{what}: no spill stores ({build['spill_store_bytes']} bytes)")


def build_spills(key: str) -> dict:
    """``{kernel: spill store bytes}`` of every kernel of a build this run
    compiled that spills (ptxas -v): empty for a build that spills nothing
    or was found built."""
    return {k: b for k, (_, b) in ptxas_report(_build.compile_log.get(key, "")).items() if b}


def german_k1(dev, kind: str, target, mass_inv, start, ref_mean, ref_std, eps_bar: float):
    """HMC(backend="cuda") at German credit's shape on one target from
    ``start`` (chains in the posterior): the step size by the pilot, the
    run's gates, the kernel against its plain version
    (1, 8 and 64 steps; chains off the float64 plain version over
    KL_OFF_SEEDS), timed beside the two torch.matmul of a leapfrog and the
    bound (the plain version's time at this shape:
    port_scripts/logistic_stream_designs.py)."""
    n_obs, p = target.X.shape
    d = p + 2
    centred = kind == "centred"
    mass_inv = mass_inv.to(dev)
    x0 = start.to(dev)
    sampler = lambda e: gmt.HMC(target, x0, e, LGH_L, seed=SEED, mass_inv=mass_inv,
                                backend="cuda")
    pilot = {f: moved_share(sampler(f * eps_bar).run(*LGG_PILOT)) for f in LGG_EPS_FACTORS}
    factor = max([f for f in LGG_EPS_FACTORS if pilot[f] >= LGG_ACCEPT_FLOOR],
                 default=LGG_EPS_FACTORS[0])
    eps = round(factor * eps_bar, 6)
    reset_counts()
    samples = sampler(eps).run(*LGH_STEPS)
    torch.cuda.synchronize()
    launches, lane = fused_hmc_logistic.launches, fused_hmc.launches
    check(launches == 1 and lane == 0,
          f"German {kind}: one logistic HMC launch ({launches}; K1 {lane})")
    store = samples.transpose(0, 1)
    check(tuple(samples.shape) == (N_CHAINS, LGH_STEPS[0], d)
          and bool(torch.isfinite(store).all()), f"German {kind} HMC: shape and finite")
    accept = moved_share(samples)
    unthinned_rhat = float(gmt.split_rhat_mean_ess(store, steps_major=True)[0].max())
    del samples, store
    gate = sampler(eps).run(*LGH_STEPS, thin=LGG_HMC_THIN)
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(gate.transpose(0, 1), steps_major=True,
                                                   return_moments=True)
    del gate
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    mean_dev, sd_dev = posterior_deviations(mean, std, ref_mean, ref_std)
    check(0.6 < accept < 0.95, f"German {kind} HMC accept {accept} within 0.6-0.95")
    check(max_rhat < 1.01,
          f"German {kind} HMC max R-hat {max_rhat} < 1.01 (thin {LGG_HMC_THIN})")
    check(float(mean_dev.max()) < LGH_MEAN_SD and float(sd_dev.max()) < LGH_SD_REL,
          f"German {kind} HMC: means within {float(mean_dev.max())} < {LGH_MEAN_SD} sd of "
          f"ChEES's, sds within {float(sd_dev.max())} < {LGH_SD_REL}")
    kw = dict(seed=SEED, mass_inv=mass_inv)
    target64, x64, m64 = target.to(dtype=torch.float64), x0.double(), mass_inv.double()
    rel, differ, abs_err = {}, {}, 0.0
    for steps in LGH_EQ_STEPS:
        got = fused_hmc.fused_hmc_run(target, x0, eps, LGH_L, steps, 0, **kw)
        want = fused_hmc.fused_hmc_run_reference(target, x0, eps, LGH_L, steps, 0, **kw)
        same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
        differ[steps] = int((~same).sum())
        rel[steps] = float((got[same] - want[same]).abs().max() / want[same].abs().max())
        abs_err = max(abs_err, float((got[same] - want[same]).abs().max()))
        del got
        # for scale: the float32 plain version against float64
        if steps == LGH_EQ_STEPS[-1]:
            want64 = fused_hmc.fused_hmc_run_reference(target64, x64, eps, LGH_L, steps, 0,
                                                       seed=SEED, mass_inv=m64)
            same64 = (accept_history(want64, x64) == accept_history(want, x0)).all(dim=1)
            rel64 = float((want[same64].double() - want64[same64]).abs().max()
                          / want64[same64].abs().max())
            del want64
        del want
        check(rel[steps] < LGH_RTOL, f"German {kind} HMC after {steps} steps: relative error "
              f"{rel[steps]} < {LGH_RTOL} ({differ[steps]} chains differ)")
    kernel_off, plain_off = chains_off(
        lambda seed: fused_hmc.fused_hmc_run(target, x0, eps, LGH_L, KL_OFF_STEPS, 0,
                                             seed=seed, mass_inv=mass_inv),
        lambda seed: fused_hmc.fused_hmc_run_reference(target, x0, eps, LGH_L, KL_OFF_STEPS,
                                                       0, seed=seed, mass_inv=mass_inv),
        lambda seed: fused_hmc.fused_hmc_run_reference(target64, x64, eps, LGH_L,
                                                       KL_OFF_STEPS, 0, seed=seed,
                                                       mass_inv=m64), x0)
    del target64
    ms, wall, o = timed(lambda: sampler(eps).run(*LGH_STEPS), 1)
    del o
    n_steps = sum(LGH_STEPS)
    leapfrogs = n_steps * LGH_L
    library_ms = library_matmul_ms(dev, [((N_CHAINS, p), (p, n_obs)),
                                         ((N_CHAINS, n_obs), (n_obs, p))], leapfrogs)
    # the bound: the gradients' two products in three TF32 passes beside the
    # rest on the CUDA cores, as "K1-logistic"'s; the state and X read once,
    # the store written once
    n_bytes = 4 * (N_CHAINS * d * (1 + LGH_STEPS[0]) + n_obs * p + n_obs)
    flops = N_CHAINS * leapfrogs * 4 * n_obs * p
    other = N_CHAINS * (leapfrogs * (8 * n_obs + 8 * p) + n_steps * 20 * n_obs)
    bounds = tile_bounds((n_bytes, other, 0), flops)
    layout = fused_hmc_logistic.launch_layout(N_CHAINS, n_obs, p)
    build = build_report(logistic_hmc_build(p),
                         f"fused_hmc_logistic_streamed_kernel<{int(centred)}>")
    spill_free(build, f"German {kind} K1's build")
    return dict(launches=launches, eps=eps, eps_factor=factor,
                pilot_accept={str(f): round(a, 4) for f, a in pilot.items()},
                accept=round(accept, 4), unthinned_max_rhat=round(unthinned_rhat, 5),
                thin=LGG_HMC_THIN, max_rhat=round(max_rhat, 5), min_ess=round(min_ess, 1),
                mean_dev_sd=round(float(mean_dev.max()), 4), sd_dev=round(float(sd_dev.max()), 4),
                worst_coordinates=[int(mean_dev.argmax()), int(sd_dev.argmax())],
                rel_err={str(k): float(f"{v:.3e}") for k, v in rel.items()},
                plain_f32_vs_f64_rel=float(f"{rel64:.3e}"),
                chains_differ={str(k): v for k, v in differ.items()}, max_abs_err=abs_err,
                off_f64_kernel=kernel_off, off_f64_plain_f32=plain_off, ms=round(ms, 3),
                wall_s=round(wall, 5), library_ms=round(library_ms, 3),
                bound_ms=bounds["bound_tensor_3xtf32_ms"], bound_by="operations",
                bound_cuda_core_ms=bounds["bound_cuda_core_ms"],
                x_bytes_read=x_bytes_read(layout, n_steps * LGH_L + 1),
                tflops=round(flops / (ms * 1e-3) / 1e12, 3),
                **{k: v for k, v in layout.items() if k != "tiles"}, **build)


def german_k3(dev, kind: str, target, x0, ref_mean, ref_std):
    """MetropolisHastings(backend="cuda") at German credit's shape on one
    target from its posterior: the run's launch and accept, R-hat and
    moments from the gate run (KG_GATE), the kernel against its plain
    version (bit-equal on the chains whose accept histories agree after 1,
    8 and 64 steps, the random walk and pCN; chains off the float64 plain
    version over KL_OFF_SEEDS), timed beside one torch.matmul a step and the
    bound (the plain version's time: port_scripts/logistic_stream_designs.py)."""
    n, d = x0.shape
    n_obs, p = target.X.shape
    centred = kind == "centred"
    scale = two_figures_down(2.38 / math.sqrt(d) * float(ref_std.min()))
    walk = gmt.RandomWalkProposal(scale)
    sampler = lambda: gmt.MetropolisHastings(target, walk, x0, seed=SEED, backend="cuda")
    reset_counts()
    samples = sampler().run(*KL_STEPS)
    torch.cuda.synchronize()
    launches, lane = fused_mh_logistic.launches, fused_mh.launches
    check(launches == 1 and lane == 0,
          f"German {kind}: one logistic MH launch ({launches}; fused_mh.cu {lane})")
    check(tuple(samples.shape) == (n, KL_STEPS[0], d) and bool(torch.isfinite(samples).all()),
          f"German {kind} MH: shape and finite")
    accept = moved_share(samples)
    check(KL_ACCEPT[0] < accept < KL_ACCEPT[1],
          f"German {kind} MH: accept {accept} within {KL_ACCEPT}")
    _, unthinned_ess = gmt.split_rhat_mean_ess(samples.transpose(0, 1), steps_major=True)
    unthinned_min_ess = float(unthinned_ess.min())
    del samples
    chains, thin = KG_GATE[kind]
    few = x0[:chains].contiguous()
    gate_ms, _, gate = timed(lambda: gmt.MetropolisHastings(
        target, walk, few, seed=SEED, backend="cuda").run(*KL_STEPS, thin=thin), 1)
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(gate.transpose(0, 1), steps_major=True,
                                                   return_moments=True)
    del gate
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    mean_dev, sd_dev = posterior_deviations(mean, std, ref_mean, ref_std)
    check(gate_ms < KG_GATE_MS,
          f"German {kind} MH: the gate run's {gate_ms} card ms < {KG_GATE_MS}")
    check(max_rhat < 1.01,
          f"German {kind} MH: max R-hat {max_rhat} < 1.01 ({chains} chains, thin {thin})")
    check(float(mean_dev.max()) < LGH_MEAN_SD and float(sd_dev.max()) < LGH_SD_REL,
          f"German {kind} MH: means within {float(mean_dev.max())} < {LGH_MEAN_SD} sd of "
          f"ChEES's, sds within {float(sd_dev.max())} < {LGH_SD_REL}")
    differ = {}
    pcn = gmt.PCNProposal(KL_PCN)
    for name, prop, xs in (("walk", walk, x0), ("pcn", pcn, x0[:KL_PCN_CHAINS].contiguous())):
        for steps in KL_EQ_STEPS:
            got = fused_mh.fused_mh_run(target, xs, prop, steps, 0, seed=SEED)
            want = fused_mh.fused_mh_run_reference(target, xs, prop, steps, 0, seed=SEED)
            same = (accept_history(got, xs) == accept_history(want, xs)).all(dim=1)
            check(torch.equal(got[same], want[same]),
                  f"German {kind} MH {name}: the chains whose accept histories agree are "
                  f"bit-equal after {steps} steps")
            differ[f"{name}_{steps}"] = int((~same).sum())
            del got, want
    target64 = target.to(dtype=torch.float64)
    kernel_off, plain_off = chains_off(
        lambda seed: fused_mh.fused_mh_run(target, x0, walk, KL_OFF_STEPS, 0, seed=seed),
        lambda seed: fused_mh.fused_mh_run_reference(target, x0, walk, KL_OFF_STEPS, 0,
                                                     seed=seed),
        lambda seed: fused_mh.fused_mh_run_reference(target64, x0.double(), walk,
                                                     KL_OFF_STEPS, 0, seed=seed), x0)
    del target64
    ms, wall, o = timed(lambda: sampler().run(*KL_STEPS), 1)
    del o
    n_steps = sum(KL_STEPS)
    library_ms = library_matmul_ms(dev, [((n, p), (p, n_obs))], n_steps)
    # the bound: "K3-logistic"'s, one product a step in three TF32 passes
    n_bytes = 4 * (n * d * (1 + KL_STEPS[0]) + n_obs * p + n_obs)
    flops = n * n_steps * 2 * n_obs * p
    other = n * n_steps * 20 * n_obs
    bounds = tile_bounds((n_bytes, other, 0), flops)
    layout = fused_mh_logistic.launch_layout(n, n_obs, p)
    build = build_report(logistic_mh_build(p),
                         f"fused_mh_logistic_streamed_kernel<0,{int(centred)}>")
    spill_free(build, f"German {kind} K3's build")
    return dict(launches=launches, walk=scale, accept=round(accept, 4),
                unthinned_min_ess=round(unthinned_min_ess, 1), gate_chains=chains, thin=thin,
                gate_ms=round(gate_ms, 1), max_rhat=round(max_rhat, 5),
                min_ess=round(min_ess, 1), mean_dev_sd=round(float(mean_dev.max()), 4),
                sd_dev=round(float(sd_dev.max()), 4),
                worst_coordinates=[int(mean_dev.argmax()), int(sd_dev.argmax())],
                chains_differ=differ, max_abs_err=0.0,
                off_f64_kernel=kernel_off, off_f64_plain_f32=plain_off, ms=round(ms, 3),
                wall_s=round(wall, 5), library_ms=round(library_ms, 3),
                bound_ms=bounds["bound_tensor_3xtf32_ms"], bound_by="operations",
                bound_cuda_core_ms=bounds["bound_cuda_core_ms"],
                x_bytes_read=x_bytes_read(layout, n_steps + 1),
                tflops=round(flops / (ms * 1e-3) / 1e12, 3),
                **{k: v for k, v in layout.items() if k != "tiles"}, **build)


def phase_logistic_german(dev):
    """The logistic family at German credit's shape at full width (10,240
    chains), X streamed: ChEES's posterior, then HMC(backend="cuda") and
    MetropolisHastings(backend="cuda") on both targets, one launch each
    (german_k1, german_k3)."""
    chees, targets = german_posterior(dev)
    out = {}
    for kind, (target, mass_inv, last, mean, std) in targets.items():
        out[f"K1_{kind}"] = german_k1(dev, kind, target, mass_inv, last, mean, std,
                                      chees["eps_bar"])
        torch.cuda.empty_cache()
        out[f"K3_{kind}"] = german_k3(dev, kind, target, last, mean, std)
        torch.cuda.empty_cache()
    say("logistic-german", chains=N_CHAINS, n_obs=LGG_OBS, p=LGG_FEATURES,
        data=f"make_logistic_data({LGG_SEED}, {LGG_OBS}, {LGG_FEATURES})",
        chees=f"{LGG_WARMUP}+{LGG_COLLECT}", chees_s=f"{chees['chees_s']:.3f}",
        chees_max_rhat=f"{chees['max_rhat']:.5f}", eps_bar=f"{chees['eps_bar']:.6f}",
        chees_spread=json.dumps({k: v for k, v in chees.items()
                                 if k not in ("eps_bar", "chees_s", "max_rhat")}),
        results=json.dumps(out))
    return out


def resident_digests(dev):
    """The resident path's stores at the stretch line's shape (256 x 48,
    make_logistic_data at LGW_SEED, the non-centred target, LGW_CHAINS
    chains, LGW_STEPS steps): K3 with the random walk and K1, each a sha256
    of its float32 bytes.  Only calls an earlier tree also has, so that a
    parent commit's package gives its own digests."""
    X, y, _ = gmt.make_logistic_data(LGW_SEED, 256, 48, device=dev)
    target = gmt.HierarchicalLogisticNC(X, y)
    x0 = gmt.init_with_seed(LGW_CHAINS, 50, 2, device=dev) / math.sqrt(48)
    x0[:, 1] -= 1.0
    x0 = x0.contiguous()
    walk = gmt.RandomWalkProposal(LGW_WALK / math.sqrt(256 * 48))
    k3 = fused_mh.fused_mh_run(target, x0, walk, LGW_STEPS, 0, seed=SEED)
    inv = torch.full((50,), 1.0 / 256, device=dev)
    k1 = fused_hmc.fused_hmc_run(target, x0, LGW_EPS, 5, LGW_STEPS, 0, seed=SEED, mass_inv=inv)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for name, t in (("K3", k3), ("K1", k1))}


def phase_logistic_wide(dev):
    """Both logistic kernels against their plain versions at each of
    LGW_CASES, both targets: K3 bit-equal on the chains whose accept
    histories agree, K1 within LGH_RTOL there; each kernel's chains off the
    float64 plain version over KL_OFF_SEEDS at most the float32 plain
    version's + KL_OFF_SLACK (chains_off: on the CPU a K3 density that
    leaves out 32 observations puts 25-446 chains a seed off, the fewest at
    10,000 x 24, where the float32 plain version puts 0-3,
    port_scripts/logistic_wide_gate_power.py); each case's path and panel
    from the kernels' host code, and the builds' registers and spills (none);
    at 256 x 48 the resident path's digests equal the parent's."""
    out = {}
    for n_obs, p in LGW_CASES:
        X, y, _ = gmt.make_logistic_data(LGW_SEED, n_obs, p, device=dev)
        x0 = gmt.init_with_seed(LGW_CHAINS, p + 2, 2, device=dev) / math.sqrt(p)
        x0[:, 1] -= 1.0
        x0 = x0.contiguous()
        walk = gmt.RandomWalkProposal(LGW_WALK / math.sqrt(n_obs * p))
        inv = torch.full((p + 2,), 1.0 / n_obs, device=dev)
        case = {}
        targets = {"nc": gmt.HierarchicalLogisticNC(X, y),
                   "centred": gmt.HierarchicalLogistic(X, y)}
        starts = {kind: fused_hmc.fused_hmc_run(target, x0, LGW_EPS, 5, 1, LGW_BURN,
                                                seed=SEED + 1, mass_inv=inv)[:, 0].contiguous()
                  for kind, target in targets.items()}
        reset_counts()
        for kind, target in targets.items():
            start = starts[kind]
            got = fused_mh.fused_mh_run(target, x0, walk, LGW_STEPS, 0, seed=SEED)
            want = fused_mh.fused_mh_run_reference(target, x0, walk, LGW_STEPS, 0, seed=SEED)
            same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
            check(torch.equal(got[same], want[same]),
                  f"logistic-wide {n_obs} x {p} {kind} K3: the chains whose accept histories "
                  f"agree are bit-equal")
            k3_accept, k3_differ = moved_share(want), int((~same).sum())
            target64 = target.to(dtype=torch.float64)
            k3_off = chains_off(
                lambda seed: fused_mh.fused_mh_run(target, x0, walk, KL_OFF_STEPS, 0, seed=seed),
                lambda seed: fused_mh.fused_mh_run_reference(target, x0, walk, KL_OFF_STEPS, 0,
                                                             seed=seed),
                lambda seed: fused_mh.fused_mh_run_reference(target64, x0.double(), walk,
                                                             KL_OFF_STEPS, 0, seed=seed),
                x0, f"logistic-wide {n_obs} x {p} {kind} K3: ")
            got = fused_hmc.fused_hmc_run(target, start, LGW_EPS, 5, LGW_STEPS, 0, seed=SEED,
                                          mass_inv=inv)
            want = fused_hmc.fused_hmc_run_reference(target, start, LGW_EPS, 5, LGW_STEPS, 0,
                                                     seed=SEED, mass_inv=inv)
            same = (accept_history(got, start) == accept_history(want, start)).all(dim=1)
            rel = float((got[same] - want[same]).abs().max() / want[same].abs().max())
            check(rel < LGH_RTOL and bool(torch.isfinite(got).all()),
                  f"logistic-wide {n_obs} x {p} {kind} K1: relative error {rel} < {LGH_RTOL}")
            k1_accept, k1_differ = moved_share(want), int((~same).sum())
            del got, want
            inv64 = inv.double()
            k1_off = chains_off(
                lambda seed: fused_hmc.fused_hmc_run(target, start, LGW_EPS, 5, KL_OFF_STEPS, 0,
                                                     seed=seed, mass_inv=inv),
                lambda seed: fused_hmc.fused_hmc_run_reference(
                    target, start, LGW_EPS, 5, KL_OFF_STEPS, 0, seed=seed, mass_inv=inv),
                lambda seed: fused_hmc.fused_hmc_run_reference(
                    target64, start.double(), LGW_EPS, 5, KL_OFF_STEPS, 0, seed=seed,
                    mass_inv=inv64), start, f"logistic-wide {n_obs} x {p} {kind} K1: ")
            del target64
            case[kind] = dict(k3_accept=round(k3_accept, 4), k3_differ=k3_differ,
                              k3_off_f64=list(k3_off), k1_accept=round(k1_accept, 4),
                              k1_differ=k1_differ, k1_rel_err=float(f"{rel:.3e}"),
                              k1_off_f64=list(k1_off))
        launches = {"K3": fused_mh_logistic.launches, "K1": fused_hmc_logistic.launches}
        # a run and one a seed of chains_off, each target
        each = 2 * (1 + len(KL_OFF_SEEDS))
        check(launches == {"K3": each, "K1": each} and fused_mh.launches == fused_hmc.launches == 0,
              f"logistic-wide {n_obs} x {p}: one launch of each logistic kernel a target "
              f"({launches})")
        for name, mod, build, kernels in (
                ("K3", fused_mh_logistic, logistic_mh_build(p),
                 ("fused_mh_logistic_streamed_kernel<0,0>", "fused_mh_logistic_kernel<0,0>")),
                ("K1", fused_hmc_logistic, logistic_hmc_build(p),
                 ("fused_hmc_logistic_streamed_kernel<0>",
                  f"fused_hmc_logistic_kernel<{fused_hmc_logistic.feature_tiles(p)},0>"))):
            lay = mod.launch_layout(LGW_CHAINS, n_obs, p)
            report = build_report(build, kernels[0] if lay["streamed"] else kernels[1])
            spills = build_spills(build)
            check(not spills, f"logistic-wide {n_obs} x {p}: {build} spills nothing ({spills})")
            case[name] = dict(launches=launches[name], streamed=lay["streamed"],
                              panel_rows=lay["panel_rows"],
                              panels=lay["panels"], tiles_a_block=lay["tiles_a_block"],
                              shared_bytes=lay["shared_bytes"], **report)
        out[f"{n_obs}x{p}"] = case
    digests = resident_digests(dev)
    for name, want in RESIDENT_DIGESTS.items():
        check(digests[name] == want,
              f"logistic-wide: the resident {name} store at 256 x 48 has the parent's digest "
              f"({digests[name]})")
    say("logistic-wide", chains=LGW_CHAINS, steps=LGW_STEPS, digests=json.dumps(digests),
        results=json.dumps(out))
    return dict(cases=out, digests=digests)


def chees_moments(samples):
    """Pooled mean [d] and covariance [d, d] of a ``[n, steps, d]`` sample,
    in float64."""
    flat = samples.reshape(-1, samples.shape[-1]).double()
    mean = flat.mean(dim=0)
    centred = flat - mean
    return mean, centred.T @ centred / (flat.shape[0] - 1)


def headline_sampler(dev):
    """The bench headline's sampler (bench.py:182-217) on the port."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev)
    return scales, gmt.ChEESHMC(target, x0, target_accept_p=CHEES_ACCEPT,
                                jitter_amount=CHEES_JITTER, static_collection=True,
                                static_leapfrog=CHEES_L, seed=SEED)


def phase_chees_small(dev):
    """ChEES at 1,024 chains through ``run``: the 2-d target with no analytic
    gradient (autograd) under the adaptive law in both phases at thin 2, a
    10-d diagonal Gaussian under the static law with a derived L; then K2 on
    the ChEES path: the headline's shape for 8 warmup and 8 static steps,
    once with the fill kernel's draws and once with the plain draws computed
    on the card and injected, equal bit for bit in every sample and every
    carry field."""
    n = CHEES_SMALL_CHAINS
    mean2, cov2 = torch.tensor(MH_MEAN, dtype=torch.float64), torch.tensor(MH_COV,
                                                                          dtype=torch.float64)
    target2 = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    warm, coll = CHEES_2D_STEPS
    s2 = gmt.ChEESHMC(target2, gmt.init_with_seed(n, 2, 1, device=dev), seed=1)
    out2 = s2.run(coll, warm, thin=2)
    check(tuple(out2.shape) == (n, coll, 2) and bool(torch.isfinite(out2).all()),
          "ChEES 2-d: shape and finite samples")
    m2, c2 = chees_moments(out2)
    err2 = (float((m2.cpu() - mean2).abs().max()), float((c2.cpu() - cov2).abs().max()))
    check(err2[0] < CHEES_MEAN_ATOL and err2[1] < CHEES_COV_ATOL,
          f"ChEES 2-d moments: mean {err2[0]} < {CHEES_MEAN_ATOL}, cov {err2[1]} < "
          f"{CHEES_COV_ATOL}")

    scales = torch.exp(torch.linspace(0.0, math.log(10.0), 10))
    target10 = gmt.GaussianND(torch.zeros(10), scales, device=dev)
    warm, coll = CHEES_10D_STEPS
    s10 = gmt.ChEESHMC(target10, gmt.init_with_seed(n, 10, 2, device=dev), seed=2,
                       target_accept_p=0.9, jitter_amount=0.5, static_collection=True)
    out10 = s10.run(coll, warm)
    check(tuple(out10.shape) == (n, coll, 10) and bool(torch.isfinite(out10).all()),
          "ChEES 10-d: shape and finite samples")
    m10, c10 = chees_moments(out10)
    std_err = float((c10.diagonal().sqrt().cpu() / scales.double() - 1.0).abs().max())
    mean_err = float(m10.abs().max())
    check(mean_err < CHEES_MEAN_ATOL and std_err < CHEES_STD_RTOL,
          f"ChEES 10-d moments: mean {mean_err} < {CHEES_MEAN_ATOL}, std/scale {std_err} < "
          f"{CHEES_STD_RTOL}")

    # K2 on the path: the same run with the fill kernel's draws and with the
    # plain draws computed on the card and injected
    warm, coll = CHEES_K2_STEPS
    _, s = headline_sampler(dev)
    reset_counts()
    got = s.run(coll, warm).transpose(0, 1)
    torch.cuda.synchronize()
    fills = counter_rng.launches
    check(fills == 2 * (warm + coll) + 1, f"ChEES K2 check: {fills} fill launches")
    got_carry = s._final_carry
    _, p = headline_sampler(dev)
    key, chains = p._key, p._chain_ids
    plain_draws = lambda m: (counter_rng.normals_paired(key, chains, m, DIM),
                             counter_rng.uniforms(key, chains, m))
    carry = p._init_carry(z_eps=counter_rng.normals_paired(key, chains, 0, DIM,
                                                           counter_rng.TAG_EPS_SEARCH))
    for m in range(warm):
        z, u = plain_draws(m)
        carry = p._step(carry, m, warm, z=z, u=u)
    step = p._static_collect_step(CHEES_L)
    want = []
    for m in range(warm, warm + coll):
        z, u = plain_draws(m)
        carry = step(carry, m, z=z, u=u)
        want.append(carry["pos"])
    torch.cuda.synchronize()
    check(counter_rng.launches == fills, "the plain draws launched no fill kernel")
    check(torch.equal(got, torch.stack(want)), "ChEES samples equal with the fill kernel's "
          "draws and the plain draws")
    differ = [k for k in carry if not torch.equal(carry[k], got_carry[k])]
    check(not differ, f"ChEES carry equal with both draws ({differ})")
    say("chees-small", chains=n, d2_steps="{}+{}x2".format(*CHEES_2D_STEPS),
        d2_mean_err=f"{err2[0]:.4f}", d2_cov_err=f"{err2[1]:.4f}",
        d10_steps="{}+{}".format(*CHEES_10D_STEPS), d10_L=s10._static_L,
        d10_mean_err=f"{mean_err:.4f}", d10_std_err=f"{std_err:.4f}",
        k2_shape=f"{N_CHAINS}x{DIM}", k2_steps=f"{warm}+{coll}", k2_fill_launches=fills,
        k2_bit_equal=True, k2_carry_fields=len(carry))
    return dict(fill_launches=fills)


def profile_window(fn, steps: int, label: str) -> dict:
    """``fn()`` (``steps`` sampler steps) under ``torch.profiler``: the
    device's busy time (the union of the intervals of its kernels and memory
    operations), its share of the call's host wall, those operations a step,
    its device-to-host copies (read-backs), and the five kernel names with
    the most device time; then the call
    again without the profiler, its CUDA-event time and host wall.  Where
    the profiler shows no device time the busy share is "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in ops)
    by_name = {}
    for e in ops:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    dtoh = sum(e.name.startswith("Memcpy DtoH") for e in ops)
    event_ms, event_wall_s, _ = timed(fn, 3)
    measured = busy_us > 0.0
    out = dict(busy_share=f"{busy_us / wall_us:.4f}" if measured else "not measured",
               device_ms=f"{busy_us / 1e3:.3f}" if measured else "not measured",
               device_ops_per_step=f"{len(ops) / steps:.1f}" if measured else "not measured",
               read_backs=dtoh if measured else "not measured", profiled_wall_ms=f"{wall_us / 1e3:.3f}", event_ms=f"{event_ms:.3f}",
               wall_ms=f"{event_wall_s * 1e3:.3f}",
               busy_share_unprofiled=f"{busy_us / 1e3 / (event_wall_s * 1e3):.4f}"
               if measured else "not measured")
    say(label, steps=steps, **out, top_device_us=json.dumps(
        {k: round(v, 1) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]}))
    return dict(busy=busy_us / wall_us if measured else None,
                ops_per_step=len(ops) / steps if measured else None,
                read_backs=dtoh if measured else None)


def fill_timings(dev, n: int, shapes: dict):
    """The fill kernel's device time at a sampler's shapes, ``{kind:
    (columns, tag)}`` for ``n`` chains (ChEES: normal pairs ``[n, d]`` and
    uniforms ``[n, 1]``), back-to-back launches, with their bounds (the
    bytes written; the Philox blocks and Box–Muller pairs).  Returns
    ``{kind: (ms, bound_ms, bound_by)}``."""
    out = {}
    for kind, (cols, tag) in shapes.items():
        buf = torch.empty((n, cols), dtype=torch.int32 if kind == "bits" else torch.float32,
                          device=dev)
        lib, launch = counter_rng.fill_launcher(buf, SEED, 7, tag, kind)
        codes = []
        ms = device_ms(lambda: codes.append(launch()), FILL_REPS)
        _build.check(lib, next((c for c in codes if c), 0), f"counter_rng_fill {kind} (timed)")
        want = counter_rng.counter_rng_fill_reference(n, cols, SEED, 7, tag, kind, device=dev)
        check(torch.equal(buf, want), f"K2 timed {kind} fill equals the plain draws")
        blocks = n * ((cols + 3) // 4)
        ops = blocks * PHILOX_OPS + n * cols * {"normal_pair": 10, "uniform": 2}.get(kind, 0)
        out[kind] = (ms, *bound(4 * n * cols, ops))
    return out


def chees_work(n: int, d: int, leapfrogs: int, steps: int, n_collect: int):
    """Bytes and operations of a ChEES run for its bound: the store written
    once and the initial positions read once (the draws need not reach
    memory: a fused kernel keeps them in registers, as K1 does); ~7
    operations an element a leapfrog (drift 2, gradient 2, kick 2, the
    select's share 1) and ~35 an element a step for the draws (a quarter of
    a Philox block and half a Box–Muller pair)."""
    n_bytes = 4 * n * d * (n_collect + 1)
    return n_bytes, 7 * n * d * leapfrogs + 35 * n * d * steps


def phase_chees_main(dev):
    """The bench headline at full size through ``ChEESHMC.run``; then three
    warm runs of ``run`` timed as bench.py times them (init + warmup +
    collection, synchronised, median), split by the phase ends ``run``
    records; a 10-step collection window under the profiler; the fill kernel
    at its ChEES shapes."""
    scales, sampler = headline_sampler(dev)
    steps = CHEES_WARMUP + CHEES_COLLECT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    samples = sampler.run(CHEES_COLLECT, CHEES_WARMUP)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fills = counter_rng.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(fills == 2 * steps + 1, f"ChEES main path: {fills} fill launches == 2 x {steps} + 1")
    check(tuple(samples.shape) == (N_CHAINS, CHEES_COLLECT, DIM), "ChEES sample shape")
    store = samples.transpose(0, 1)  # the steps-major store
    check(bool(torch.isfinite(store).all()), "every ChEES sample is finite")
    t0 = time.perf_counter()
    rhat, ess, _mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                    return_moments=True)
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    diag_s = time.perf_counter() - t0
    audit = float((std.cpu() / scales - 1.0).abs().max())
    check(max_rhat < 1.01, f"ChEES max R-hat {max_rhat} < 1.01")
    check(audit < 0.05, f"ChEES moment audit max|std/scale - 1| {audit} < 0.05")
    accept = float(torch.stack([(store[k + 1] != store[k]).any(dim=1).float().mean()
                                for k in range(CHEES_COLLECT - 1)]).mean())
    carry = sampler._final_carry
    eps_bar = float(sampler.adapted_step_size)
    t_len = float(sampler.adapted_trajectory_length)
    mass_err = float((sampler.adapted_mass_inv.cpu() / scales**2 - 1.0).abs().max())
    divergences = int(sampler.divergences.sum())
    leapfrogs = int(sampler.leapfrog_count.sum())
    del samples, carry  # the store stays: resume-main, progress-main, rank-main read it

    # warm runs through ChEESHMC.run, split by the phase ends it records
    walls, parts = [], []
    for _ in range(3):
        warm = sampler.run(CHEES_COLLECT, CHEES_WARMUP, time_phases=True)
        phases = sampler.phase_seconds
        walls.append(sum(phases.values()))
        parts.append((phases["init"], phases["warmup"], phases["collection"]))
        del warm
    order = sorted(range(3), key=walls.__getitem__)
    wall, (init_s, warm_s, coll_s) = walls[order[1]], parts[order[1]]
    adapted = sampler._final_carry

    # a 10-step collection window under the profiler, beside its CUDA-event
    # time and host wall unprofiled
    window = lambda: sampler._run_static(adapted, CHEES_WINDOW, steps)
    window()
    prof = profile_window(window, CHEES_WINDOW, "chees-main-window")
    fill = fill_timings(dev, N_CHAINS, {"normal_pair": (DIM, counter_rng.TAG_MOMENTUM),
                                        "uniform": (1, counter_rng.TAG_ACCEPT)})

    n_bytes, n_ops = chees_work(N_CHAINS, DIM, leapfrogs // N_CHAINS, steps, CHEES_COLLECT)
    b_ms, b_by = bound(n_bytes, n_ops)
    say("chees-main", chains=N_CHAINS, dim=DIM, steps=f"{CHEES_WARMUP}+{CHEES_COLLECT}",
        L=sampler._static_L, accept=f"{accept:.4f}", eps_bar=f"{eps_bar:.6f}",
        T=f"{t_len:.6f}", divergences=divergences, mass_inv_err=f"{mass_err:.5f}",
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}", moment_audit=f"{audit:.5f}",
        fill_launches=fills, first_run_s=f"{first_s:.3f}", wall_s=f"{wall:.4f}",
        walls_s=json.dumps([round(w, 4) for w in walls]), init_s=f"{init_s:.4f}",
        warmup_s=f"{warm_s:.4f}", collection_s=f"{coll_s:.4f}",
        diagnostics_s=f"{diag_s:.4f}", min_ess_per_s=f"{min_ess / wall:.4e}",
        grad_evals_per_s=f"{leapfrogs / wall:.4e}", leapfrogs=leapfrogs,
        peak_memory_gb=f"{peak_gb:.2f}", fill_normal_pair_ms=f"{fill['normal_pair'][0]:.5f}",
        fill_uniform_ms=f"{fill['uniform'][0]:.5f}", bound_ms=f"{b_ms:.3f}",
        bound_by=b_by, wall_over_bound=f"{wall * 1e3 / b_ms:.1f}")
    return dict(fill_launches=fills, wall=wall, fill=fill, busy=prof["busy"],
                ops_per_step=prof["ops_per_step"], min_ess=min_ess, store=store,
                L=sampler._static_L, eps_bar=eps_bar, T=t_len)


def phase_chees_logistic(dev):
    """The bench stretch line (bench.py:737-760) on the port's
    ``HierarchicalLogisticNC``, on bench.py's own data (the JAX package's
    ``make_logistic_data(PRNGKey(1), 256, 48)``, which the port ships as
    ``general_mcmc_torch/data/bench_logistic_k1.npz``): 10,240 chains, 256
    adaptive warmup steps, 1,024 static steps with a derived L and the
    in-run statistics (``run(with_stats=True)``), two runs, the wall the
    lesser (bench.py:780-808), split by the phase ends ``run`` records; the
    post-warmup divergences, how many chains had one and the most in one
    chain."""
    X, y, _ = bench_logistic_data(device=dev)
    target = gmt.HierarchicalLogisticNC(X, y)
    sampler = gmt.ChEESHMC(target, gmt.init_with_seed(N_CHAINS, LGC_DIM, SEED, device=dev),
                           target_accept_p=LGC_ACCEPT, jitter_amount=LGC_JITTER,
                           static_collection=True, seed=SEED)
    walls, parts = [], []
    for _ in range(2):
        samples = None
        samples = sampler.run(LGC_COLLECT, LGC_WARMUP, with_stats=True, time_phases=True)
        stats = sampler._suffstats
        phases = sampler.phase_seconds
        walls.append(sum(phases.values()))
        parts.append((phases["init"], phases["warmup"], phases["collection"]))
    best = min(range(2), key=walls.__getitem__)
    wall, (init_s, warm_s, coll_s) = walls[best], parts[best]
    check(bool(torch.isfinite(samples).all()), "every logistic ChEES sample is finite")
    rhat, ess, post_mean, post_std = gmt.combine_suffstats_host(*stats)
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    check(max_rhat < 1.01, f"logistic ChEES max R-hat {max_rhat} < 1.01")
    leapfrogs = int(sampler.leapfrog_count.sum())
    per_chain = sampler.divergences
    divergences = int(per_chain.sum())
    adapted = sampler._final_carry
    profile_window(lambda: sampler._run_static(adapted, CHEES_WINDOW, LGC_WARMUP + LGC_COLLECT),
                   CHEES_WINDOW, "chees-logistic-window")
    say("chees-logistic", chains=N_CHAINS, dim=LGC_DIM, n_obs=LGC_OBS,
        steps=f"{LGC_WARMUP}+{LGC_COLLECT}", L=sampler._static_L,
        eps_bar=f"{float(sampler.adapted_step_size):.6f}",
        T=f"{float(sampler.adapted_trajectory_length):.6f}",
        data="bench_logistic_k1.npz", divergences=divergences,
        divergence_rate=f"{divergences / (N_CHAINS * LGC_COLLECT):.4e}",
        chains_diverging=int((per_chain > 0).sum()), most_in_a_chain=int(per_chain.max()),
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}", wall_s=f"{wall:.4f}",
        walls_s=json.dumps([round(w, 4) for w in walls]), init_s=f"{init_s:.4f}",
        warmup_s=f"{warm_s:.4f}", collection_with_stats_s=f"{coll_s:.4f}",
        min_ess_per_s=f"{min_ess / wall:.4e}", grad_evals_per_s=f"{leapfrogs / wall:.4e}")
    # the centred coordinates' moments: the last run's draws mapped to
    # (mu, log tau, beta), in float64, a block of chains at a time
    s1 = torch.zeros(LGC_DIM, dtype=torch.float64, device=dev)
    s2 = s1.clone()
    for rows in torch.split(samples, 1024):
        mapped = torch.cat([rows[..., :2], target.beta(rows)], dim=-1).double()
        s1 += mapped.sum(dim=(0, 1))
        s2 += (mapped * mapped).sum(dim=(0, 1))
    count = samples.shape[0] * samples.shape[1]
    mapped_mean = s1 / count
    mapped_std = torch.sqrt(s2 / count - mapped_mean * mapped_mean)
    return dict(wall=wall, max_rhat=max_rhat, eps_bar=float(sampler.adapted_step_size),
                mass_inv=sampler.adapted_mass_inv.float(), mean=torch.as_tensor(post_mean),
                std=torch.as_tensor(post_std), last=samples[:, -1].contiguous(),
                mapped_mean=mapped_mean.cpu(), mapped_std=mapped_std.cpu())


def nuts_moments_check(samples, what: str):
    """The 2-d target's pooled mean and covariance against its own."""
    m, c = chees_moments(samples)
    errs = (float((m.cpu() - torch.tensor(MH_MEAN, dtype=torch.float64)).abs().max()),
            float((c.cpu() - torch.tensor(MH_COV, dtype=torch.float64)).abs().max()))
    check(bool(torch.isfinite(samples).all()), f"NUTS {what}: finite samples")
    check(errs[0] < NUTS_MEAN_ATOL and errs[1] < NUTS_COV_ATOL,
          f"NUTS {what} moments: mean {errs[0]} < {NUTS_MEAN_ATOL}, cov {errs[1]} < "
          f"{NUTS_COV_ATOL}")
    return errs


def nuts_headline(dev, mass_config=None, backend="torch", n=None):
    """The bench's NUTS leg (bench.py:218-232) on the port at ``n`` chains
    (default ``N_CHAINS``), through the dynamic tree unless ``backend``
    names another."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(n or N_CHAINS, DIM, SEED, device=dev)
    cfg = mass_config or gmt.NUTSMassMatrixConfig(adaptation="diagonal")
    return scales, gmt.NUTS(target, x0, target_accept_p=NUTS_ACCEPT, mass_config=cfg,
                            max_tree_depth=NUTS_DEPTH, warmup_tree_depth=NUTS_DEPTH,
                            proposal="multinomial", seed=SEED, backend=backend)


def nuts_fills(n_steps: int, window_ends: int) -> int:
    """Fill launches of a NUTS run: two a step (momenta, tree uniforms), one
    for the initial step-size search and one for each window's re-search."""
    return 2 * n_steps + 1 + window_ends


def phase_nuts_small(dev):
    """NUTS at 1,024 chains through ``run``: the 2-d autograd target with the
    diagonal metric, the dense metric and the multinomial proposal against
    its moments; Neal's funnel at a coarse fixed step size (divergences); a
    4-d Rosenbrock smoke run; then K2 on the NUTS path: the headline's shape
    with a 30-step warmup (two window ends) and 8 collection steps, once
    with the fill kernel's draws and once with the plain draws computed on
    the card and injected, equal bit for bit in every sample and carry
    field."""
    n = NUTS_SMALL_CHAINS
    target2 = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    warm, coll = NUTS_2D_STEPS
    errs, adapted = {}, {}
    for name, adaptation, proposal in (("diag", "diagonal", "slice"),
                                       ("dense", "dense", "slice"),
                                       ("multinomial", "diagonal", "multinomial")):
        s = gmt.NUTS(target2, gmt.init_with_seed(n, 2, 1, device=dev), 0.8, seed=1,
                     max_tree_depth=NUTS_2D_DEPTH, proposal=proposal, backend="torch",
                     mass_config=gmt.NUTSMassMatrixConfig(adaptation=adaptation))
        out = s.run(coll, warm)
        check(tuple(out.shape) == (n, coll, 2), f"NUTS {name}: sample shape")
        errs[name] = nuts_moments_check(out, name)
        # the median chain's M⁻¹ against the covariance (its diagonal)
        inv = s._final_carry["mass"].inv.median(dim=0).values.cpu().double()
        cov = torch.tensor(MH_COV, dtype=torch.float64)
        adapted[name] = float((inv - (cov if adaptation == "dense" else cov.diagonal()))
                              .abs().max())
    check(adapted["dense"] < 2.0 and adapted["diag"] < 2.0,
          f"NUTS adapted metrics near the covariance ({adapted})")

    funnel = gmt.NUTS(gmt.NealsFunnel(dim=8), gmt.init_with_seed(n, 8, 3, device=dev), 0.8,
                      seed=3, step_size=NUTS_FUNNEL_EPS, max_tree_depth=6, backend="torch")
    funnel.run(NUTS_FUNNEL_STEPS, 0)
    funnel_div = int(funnel.divergences.sum())
    check(funnel_div > 0, f"NUTS funnel at step size {NUTS_FUNNEL_EPS}: {funnel_div} divergences")
    rosen = gmt.NUTS(gmt.RosenbrockND(), gmt.init_with_seed(n, 4, 4, device=dev) * 0.1, 0.95,
                     seed=4, max_tree_depth=6, backend="torch")
    r_out = rosen.run(NUTS_ROSEN_STEPS[1], NUTS_ROSEN_STEPS[0])
    check(bool(torch.isfinite(r_out).all()), "NUTS Rosenbrock: finite samples")

    fills, ends, n_fields = nuts_k2_check(dev, "torch")
    say("nuts-small", chains=n, d2_steps="{}+{}".format(*NUTS_2D_STEPS),
        d2_depth=NUTS_2D_DEPTH,
        **{f"{k}_mean_err": f"{v[0]:.4f}" for k, v in errs.items()},
        **{f"{k}_cov_err": f"{v[1]:.4f}" for k, v in errs.items()},
        diag_metric_err=f"{adapted['diag']:.4f}", dense_metric_err=f"{adapted['dense']:.4f}",
        funnel_divergences=funnel_div, funnel_steps=NUTS_FUNNEL_STEPS,
        rosenbrock_steps="{}+{}".format(*NUTS_ROSEN_STEPS),
        k2_shape=f"{N_CHAINS}x{DIM}", k2_steps="{}+{}".format(*NUTS_K2_STEPS),
        k2_window_ends=ends, k2_fill_launches=fills, k2_bit_equal=True,
        k2_carry_fields=n_fields)
    return dict(fill_launches=fills)


def nuts_k2_check(dev, backend: str):
    """K2 on a NUTS path: the headline's shape through ``backend`` with a
    30-step warmup (two window ends) and 8 collection steps, once with the
    fill kernel's draws and once with the plain draws computed on the card
    and injected, equal bit for bit in every sample and carry field.
    Returns the fill launches, the window ends and the carry fields."""
    warm, coll = NUTS_K2_STEPS
    cfg = gmt.NUTSMassMatrixConfig(adaptation="diagonal", **NUTS_SHORT_WINDOWS)
    _, s = nuts_headline(dev, cfg, backend)
    reset_counts()
    got = s.run(coll, warm).transpose(0, 1)
    torch.cuda.synchronize()
    fills = counter_rng.launches
    ends = int(s._window_sched.sum())
    check(ends == 2 and fills == nuts_fills(warm + coll, ends),
          f"NUTS {backend} K2 check: {fills} fill launches, {ends} window ends")
    got_carry = s._final_carry
    _, p = nuts_headline(dev, cfg, backend)
    key, chains = p._key, p._chain_ids
    p._prepare_run(coll, warm)
    carry = p._init_carry(z_eps=counter_rng.normals_paired(key, chains, 0, DIM,
                                                           counter_rng.TAG_EPS_SEARCH))
    want = []
    for m in range(warm + coll):
        depth = p._depth(m)
        z = counter_rng.normals_paired(key, chains, m, DIM)
        if backend == "static":
            w = counter_rng.counter_rng_fill_reference(
                N_CHAINS, counter_rng.static_words(depth), key, m, counter_rng.TAG_STATIC,
                "bits", dev)
            draws = static_tree.StaticDraws.from_words(z, w, depth, carry["mass"])
        else:
            u = counter_rng.counter_rng_fill_reference(N_CHAINS, tree.tree_words(depth), key,
                                                       m, counter_rng.TAG_TREE, "uniform", dev)
            draws = tree.TreeDraws.from_uniforms(z, u, depth)
        z_window = counter_rng.normals_paired(key, chains, m, DIM, counter_rng.TAG_EPS_WINDOW)
        carry = p._step(carry, m, draws=draws, z_window=z_window)
        if m >= warm:
            want.append(carry["pos"])
    torch.cuda.synchronize()
    check(counter_rng.launches == fills, "the plain draws launched no fill kernel")
    check(torch.equal(got, torch.stack(want)), f"NUTS {backend} samples equal with the fill "
          "kernel's draws and the plain draws")
    flat = lambda c: {f"{k}.{i}" if isinstance(v, tuple) else k: x
                      for k, v in c.items()
                      for i, x in (enumerate(v) if isinstance(v, tuple) else [(0, v)])}
    mine, theirs = flat(carry), flat(got_carry)
    differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    check(not differ and set(mine) == set(theirs),
          f"NUTS {backend} carry equal with both draws ({differ})")
    return fills, ends, len(mine)


class DepthProbe:
    """Counts the doublings of every transition while installed: wraps the
    sampler module's tree step ``name`` (``nuts_tree_step`` or
    ``static_nuts_step``) and adds each result's depths to a device total
    (two small device operations a step, no read-back)."""

    def __init__(self, dev, name: str = "nuts_tree_step"):
        self.total = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = 0
        self._name = name
        self._inner = getattr(nuts_module, name)

    def __call__(self, *args, **kw):
        res = self._inner(*args, **kw)
        self.total += res.depth.sum()
        self.steps += 1
        return res

    def __enter__(self):
        setattr(nuts_module, self._name, self)
        return self

    def __exit__(self, *exc):
        setattr(nuts_module, self._name, self._inner)


def nuts_work(n: int, d: int, leapfrogs: int, steps: int, n_collect: int):
    """Bytes and operations of a NUTS run for its bound: the store written
    once and the initial positions read once (the draws need not reach
    memory, as in chees_work); ~13 operations an element a leapfrog (drift
    2, gradient 2, kick 2, the velocity 1, the energy's dot 2, the U-turn
    dots and the proposal's select ~4) and ~35 an element a step for the
    momentum draws."""
    n_bytes = 4 * n * d * (n_collect + 1)
    return n_bytes, 13 * n * d * leapfrogs + 35 * n * d * steps


def phase_nuts_leg(dev, backend: str):
    """The bench's NUTS leg at full size through ``NUTS.run`` with
    ``backend`` ("nuts-main": ``"torch"``, the dynamic tree; "nuts-static":
    ``"static"``, as ``bench.py`` runs it), once, timed by the phase ends
    ``run`` records, with the tree depths counted; then a 10-step collection
    window under the profiler and the fill kernel at the path's shapes."""
    label = "nuts-static" if backend == "static" else "nuts-main"
    static = backend == "static"
    n_collect = NUTS_COLLECT if static else NUTS_MAIN_COLLECT
    scales, sampler = nuts_headline(dev, backend=backend)
    steps = NUTS_WARMUP + n_collect
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with DepthProbe(dev, "static_nuts_step" if static else "nuts_tree_step") as probe:
        samples = sampler.run(n_collect, NUTS_WARMUP, time_phases=True)
    torch.cuda.synchronize()
    fills = counter_rng.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phases = sampler.phase_seconds
    wall = sum(phases.values())
    ends = int(sampler._window_sched.sum())
    check(fills == nuts_fills(steps, ends),
          f"{label}: {fills} fill launches == 2 x {steps} + 1 + {ends}")
    check(probe.steps == steps, f"the depth probe saw {probe.steps} of {steps} steps")
    check(tuple(samples.shape) == (N_CHAINS, n_collect, DIM), f"{label} sample shape")
    store = samples.transpose(0, 1)  # the steps-major store
    check(bool(torch.isfinite(store).all()), f"every {label} sample is finite")
    t0 = time.perf_counter()
    rhat, ess, _mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                    return_moments=True)
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    diag_s = time.perf_counter() - t0
    audit = float((std.cpu() / scales - 1.0).abs().max())
    check(max_rhat < 1.01, f"{label} max R-hat {max_rhat} < 1.01")
    check(audit < 0.05, f"{label} moment audit max|std/scale - 1| {audit} < 0.05")
    leapfrogs = int(sampler.leapfrog_count.sum())
    window = (1 << NUTS_DEPTH) - 1
    check(not static or leapfrogs == window * steps * N_CHAINS,
          f"{label}: {leapfrogs} leapfrogs == {window} a step")
    divergences = int(sampler.divergences.sum())
    eps_bar = sampler.adapted_step_size
    mass_err = float((sampler._final_carry["mass"].inv.median(dim=0).values.cpu() / scales**2
                      - 1.0).abs().max())
    mean_depth = float(probe.total) / (steps * N_CHAINS)
    del samples, store
    adapted = sampler._final_carry

    # a 10-step collection window under the profiler, beside its CUDA-event
    # time and host wall unprofiled
    window_fn = lambda: gmt.run_kernel(sampler._step_fn, adapted, CHEES_WINDOW, 0,
                                       step_offset=steps)
    window_fn()
    prof = profile_window(window_fn, CHEES_WINDOW, f"{label}-window")
    if static:
        words, kind, tag = counter_rng.static_words(NUTS_DEPTH), "bits", counter_rng.TAG_STATIC
    else:
        words, kind, tag = tree.tree_words(NUTS_DEPTH), "uniform", counter_rng.TAG_TREE
    fill = fill_timings(dev, N_CHAINS, {"normal_pair": (DIM, counter_rng.TAG_MOMENTUM),
                                        kind: (words, tag)})
    fill = {f"{k}_{N_CHAINS}x{DIM if k == 'normal_pair' else words}": v
            for k, v in fill.items()}

    n_bytes, n_ops = nuts_work(N_CHAINS, DIM, leapfrogs // N_CHAINS, steps, n_collect)
    b_ms, b_by = bound(n_bytes, n_ops)
    say(label, chains=N_CHAINS, dim=DIM, steps=f"{NUTS_WARMUP}+{n_collect}",
        backend=backend, max_tree_depth=NUTS_DEPTH, accept_target=NUTS_ACCEPT,
        proposal="multinomial", eps_bar_median=f"{float(eps_bar.median()):.6f}",
        mass_inv_err=f"{mass_err:.5f}", window_ends=ends, divergences=divergences,
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}", moment_audit=f"{audit:.5f}",
        fill_launches=fills, wall_s=f"{wall:.4f}", init_s=f"{phases['init']:.4f}",
        warmup_s=f"{phases['warmup']:.4f}", collection_s=f"{phases['collection']:.4f}",
        diagnostics_s=f"{diag_s:.4f}", min_ess_per_s=f"{min_ess / wall:.4e}",
        grad_evals_per_s=f"{leapfrogs / wall:.4e}", leapfrogs=leapfrogs,
        leapfrogs_per_step=f"{leapfrogs / (steps * N_CHAINS):.4f}",
        mean_tree_depth=f"{mean_depth:.4f}", ms_per_step=f"{wall * 1e3 / steps:.3f}",
        peak_memory_gb=f"{peak_gb:.2f}",
        fill_ms=json.dumps({k: round(v[0], 5) for k, v in fill.items()}),
        bound_ms=f"{b_ms:.3f}", bound_by=b_by, wall_over_bound=f"{wall * 1e3 / b_ms:.1f}")
    return dict(fill_launches=fills, wall=wall, fill=fill, busy=prof["busy"],
                min_ess_per_s=min_ess / wall, ms_per_step=wall * 1e3 / steps)


def phase_nuts_static_small(dev):
    """NUTS through the static window at 1,024 chains and the leg's cap: the
    2-d autograd target with the diagonal metric and the slice proposal and
    with the dense metric and the multinomial proposal, against its moments
    and metric; the funnel at a coarse fixed step size (divergences); K2 on
    the static path (:func:`nuts_k2_check`); then ``backend="auto"`` on the
    headline target at 1,024 chains, which must pick ``"static"`` and run
    its collection through it."""
    n = NUTS_SMALL_CHAINS
    target2 = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    warm, coll = NUTS_2D_STEPS
    errs, adapted = {}, {}
    for name, adaptation, proposal in (("diag_slice", "diagonal", "slice"),
                                       ("dense_multinomial", "dense", "multinomial")):
        s = gmt.NUTS(target2, gmt.init_with_seed(n, 2, 1, device=dev), 0.8, seed=1,
                     max_tree_depth=NUTS_DEPTH, proposal=proposal, backend="static",
                     mass_config=gmt.NUTSMassMatrixConfig(adaptation=adaptation))
        out = s.run(coll, warm)
        check(tuple(out.shape) == (n, coll, 2), f"NUTS static {name}: sample shape")
        errs[name] = nuts_moments_check(out, f"static {name}")
        inv = s._final_carry["mass"].inv.median(dim=0).values.cpu().double()
        cov = torch.tensor(MH_COV, dtype=torch.float64)
        adapted[name] = float((inv - (cov if adaptation == "dense" else cov.diagonal()))
                              .abs().max())
        check(int(s.leapfrog_count.min()) == (warm + coll) * ((1 << NUTS_DEPTH) - 1),
              f"NUTS static {name}: the full window every step")
    check(max(adapted.values()) < 2.0, f"NUTS static adapted metrics near the covariance "
          f"({adapted})")

    funnel = gmt.NUTS(gmt.NealsFunnel(dim=8), gmt.init_with_seed(n, 8, 3, device=dev), 0.8,
                      seed=3, step_size=NUTS_FUNNEL_EPS, max_tree_depth=NUTS_DEPTH,
                      backend="static")
    funnel.run(NUTS_FUNNEL_STEPS, 0)
    funnel_div = int(funnel.divergences.sum())
    check(funnel_div > 0, f"NUTS static funnel at step size {NUTS_FUNNEL_EPS}: {funnel_div} "
          "divergences")

    fills, ends, n_fields = nuts_k2_check(dev, "static")

    warm, coll = NUTS_STATIC_AUTO_STEPS
    _, auto = nuts_headline(dev, backend="auto", n=n)
    with DepthProbe(dev, "static_nuts_step") as probe:
        out = auto.run(coll, warm)
    check(auto.backend_selected == "static" and probe.steps == coll,
          f"NUTS auto on the headline target picked {auto.backend_selected!r} "
          f"({probe.steps} static steps)")
    check(bool(torch.isfinite(out).all()), "NUTS auto: finite samples")
    mean, std = auto.depth_stats
    say("nuts-static-small", chains=n, d2_steps="{}+{}".format(*NUTS_2D_STEPS),
        max_tree_depth=NUTS_DEPTH,
        **{f"{k}_mean_err": f"{v[0]:.4f}" for k, v in errs.items()},
        **{f"{k}_cov_err": f"{v[1]:.4f}" for k, v in errs.items()},
        **{f"{k}_metric_err": f"{v:.4f}" for k, v in adapted.items()},
        funnel_divergences=funnel_div, funnel_steps=NUTS_FUNNEL_STEPS,
        k2_shape=f"{N_CHAINS}x{DIM}", k2_steps="{}+{}".format(*NUTS_K2_STEPS),
        k2_window_ends=ends, k2_fill_launches=fills, k2_bit_equal=True,
        k2_carry_fields=n_fields, auto_steps=f"{warm}+{coll}",
        auto_backend_selected=auto.backend_selected, auto_depth_mean=f"{mean:.4f}",
        auto_depth_std=f"{std:.4f}")
    return dict(fill_launches=fills)


def runtime_samplers(dev):
    """The runtime-small samplers: ``{name: factory(seed)}`` at 256 chains
    of the 2-d autograd target (MH: the Gaussian, and a Poisson count on
    integer states; NUTS at the leg's cap with the diagonal metric; replica
    exchange over 3 rungs, swapping every other step; Gibbs: the
    reference's mixture)."""
    n = RT_CHAINS
    x0 = lambda: gmt.init_with_seed(n, 2, 5, device=dev)
    t2 = lambda: gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=dev)
    nuts = lambda backend: lambda seed: gmt.NUTS(
        t2(), x0(), 0.8, seed=seed, max_tree_depth=NUTS_DEPTH, backend=backend,
        proposal="multinomial", mass_config=gmt.NUTSMassMatrixConfig(adaptation="diagonal",
                                                                      **NUTS_SHORT_WINDOWS))
    return {
        "hmc": lambda seed: gmt.HMC(t2(), x0(), 0.2, 5, seed=seed),
        "mh": lambda seed: gmt.MetropolisHastings(gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev),
                                                  gmt.RandomWalkProposal(MH_SCALE), x0(),
                                                  seed=seed),
        "mh_int": lambda seed: gmt.MetropolisHastings(
            gmt.Poisson(4.0), gmt.DiscreteWalkProposal(),
            torch.full((n, 1), 4, dtype=torch.int32, device=dev), seed=seed),
        "chees": lambda seed: gmt.ChEESHMC(t2(), x0(), seed=seed),
        "chees_static": lambda seed: gmt.ChEESHMC(t2(), x0(), seed=seed, static_collection=True),
        "nuts_torch": nuts("torch"),
        "nuts_static": nuts("static"),
        "nuts_auto": nuts("auto"),
        "mala": lambda seed: gmt.MALA(t2(), x0(), 0.5, seed=seed),
        "gibbs": lambda seed: gmt.GibbsSampler(MixtureConditional(), mixture_inits(n, dev),
                                               seed=seed),
        "tempering": lambda seed: gmt.ReplicaExchange(
            t2(), x0(), gmt.geometric_temperatures(3, 4.0, device=dev), scale=0.8,
            swap_every=2, seed=seed),
    }


# Fill launches a step of each runtime-small sampler's collection (the
# "torch" step of HMC and MH, the eager samplers).
RT_FILLS_PER_STEP = {"hmc": 2, "mh": 1, "mh_int": 1, "chees": 2, "chees_static": 2,
                     "nuts_torch": 2, "nuts_static": 2, "nuts_auto": 2, "mala": 1, "gibbs": 2,
                     "tempering": 2}
# The samplers whose run runtime-small also holds against the plain draws.
RT_PLAIN = ("hmc", "mh", "mh_int", "mala", "gibbs", "tempering")


def phase_runtime_small(dev, tmp: str):
    """The sampler runtime at 256 chains, every check ``torch.equal``: for
    every sampler ``run(N, K)`` equals ``run(N₁, K)`` + ``save_checkpoint``
    + ``resume(N − N₁)`` on a fresh sampler of another seed (the
    checkpoint's stream is resumed; ``"auto"`` resumes on the sampler that
    ran, which keeps its resolved tree); ``chain(K)`` + ``step(K)`` +
    ``step(N)`` and both ``run_progress`` modes equal ``run`` (but for
    ``"auto"``, whose incremental and progress drivers step one tree);
    ``track(f).run`` is ``f`` of ``run``; ``save_checkpoint`` after
    ``HMC(backend="cuda").run`` raises; every resumed segment makes its
    sampler's fill launches a step (``RT_FILLS_PER_STEP``); the run of HMC,
    MH (float and integer), MALA, Gibbs and replica exchange equals the same
    steps with the plain draws computed on the card and injected."""
    factories = runtime_samplers(dev)
    K, N, N1 = RT_WARMUP, RT_COLLECT, RT_SPLIT
    f = lambda x: torch.stack([x[:, 0] - x[:, -1], 2.0 * x[:, 0]], dim=1)
    checked = {}
    t0 = time.perf_counter()
    reset_counts()
    for name, make in factories.items():
        ref = make(SEED).run(N, K)
        part = make(SEED)
        first = part.run(N1, K)
        path = f"{tmp}/{name}.npz"
        part.save_checkpoint(path)
        auto = name == "nuts_auto"
        resumer = part if auto else make(SEED + 1)
        fills0 = counter_rng.launches
        rest = resumer.resume(path, N - N1)
        torch.cuda.synchronize()
        per_step = RT_FILLS_PER_STEP[name]
        check(counter_rng.launches - fills0 == per_step * (N - N1),
              f"{name} resume: {counter_rng.launches - fills0} fill launches for "
              f"{N - N1} steps ({per_step} a step)")
        check(torch.equal(torch.cat([first, rest], dim=1), ref),
              f"{name}: run(N1) + checkpoint + resume equals run(N)")
        names = ["resume"]
        if name in RT_PLAIN:
            fills0 = counter_rng.launches
            plain = plain_run(make(SEED), N, K, plain_draws(name, make(SEED)))
            torch.cuda.synchronize()
            check(counter_rng.launches == fills0, f"{name}: the plain draws launched no fill")
            check(torch.equal(plain, ref), f"{name}: run equals the run with the plain draws")
            names.append("plain")
        if not auto:
            ch = make(SEED).chain(K)
            ch.step(K)
            block = ch.step(N)
            if name != "chees_static":  # chain steps the adaptive law
                check(torch.equal(block, ref), f"{name}: chain(K) + step(K) + step(N) == run")
                names.append("chain")
            for mode in ("stream", "chunked"):
                got, _stats = make(SEED).run_progress(N, K, progress=False, mode=mode)
                check(torch.equal(got, ref), f"{name}: run_progress {mode} == run")
            names.append("progress")
        if not name.startswith("mh_int"):
            tracked = make(SEED).track(f).run(N, K)
            check(torch.equal(tracked, f(ref.reshape(-1, 2)).reshape(RT_CHAINS, N, 2)),
                  f"{name}: track(f).run == f(run)")
            names.append("track")
        checked[name] = "+".join(names)
    torch.cuda.synchronize()
    fills = counter_rng.launches
    # a checkpoint written on the card resumes on the CPU
    hmc_cpu = gmt.HMC(gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device="cpu"),
                      gmt.init_with_seed(RT_CHAINS, 2, 5, device="cpu"), 0.2, 5, seed=SEED + 1,
                      device="cpu")
    on_cpu = hmc_cpu.resume(f"{tmp}/hmc.npz", 3)
    check(on_cpu.device.type == "cpu" and tuple(on_cpu.shape) == (RT_CHAINS, 3, 2)
          and bool(torch.isfinite(on_cpu).all()), "a card checkpoint resumes on the CPU")
    fused = gmt.HMC(gmt.GaussianND(torch.zeros(2), torch.ones(2), device=dev),
                    gmt.init_with_seed(RT_CHAINS, 2, 5, device=dev), 0.2, 5, backend="cuda")
    fused.run(4, 2)
    try:
        fused.save_checkpoint(f"{tmp}/fused.npz")
        raise RuntimeError("check failed: save_checkpoint after a fused run did not raise")
    except RuntimeError as e:
        check("nothing to checkpoint" in str(e), f"fused run: {e}")
    say("runtime-small", chains=RT_CHAINS, steps=f"{K}+{N}", split=N1,
        wall_s=f"{time.perf_counter() - t0:.2f}",
        checked=json.dumps(checked), fused_checkpoint_raises=True, resumed_on_cpu=True,
        resume_fills_per_step=json.dumps(RT_FILLS_PER_STEP), fill_launches=fills)
    return dict(fill_launches=fills)


def phase_resume_main(dev, store, tmp: str):
    """The ChEES headline at full width checkpointed half way:
    ``run(1536, 192)``, ``save_checkpoint``, then ``resume(1536)`` on a
    fresh sampler of another seed; both halves equal the uninterrupted
    store of "chees-main" bit for bit.  Prints the checkpoint's bytes, the
    save and load seconds, the resume's wall and its fill launches."""
    half = CHEES_COLLECT // 2
    path = f"{tmp}/chees_main.npz"
    reset_counts()
    _, part = headline_sampler(dev)
    first = part.run(half, CHEES_WARMUP)
    torch.cuda.synchronize()
    first_fills = counter_rng.launches
    t0 = time.perf_counter()
    part.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    n_bytes = os.path.getsize(path)
    check(torch.equal(first, store[:half].transpose(0, 1)),
          "resume-main: run(1536, 192) equals the first half of chees-main")
    del first
    t0 = time.perf_counter()
    loaded = load_carry(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del loaded
    _, fresh = headline_sampler(dev)
    fresh.set_seed(SEED + 1)  # the checkpoint's stream, whatever the sampler's seed
    fills0 = counter_rng.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest = fresh.resume(path, half)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume_fills = counter_rng.launches - fills0
    check(resume_fills == 2 * half, f"resume-main: {resume_fills} fill launches == 2 x {half}")
    check(torch.equal(rest, store[half:].transpose(0, 1)),
          "resume-main: resume(1536) equals the second half of chees-main")
    check(fresh._steps_done == CHEES_WARMUP + CHEES_COLLECT, "resume-main: step count")
    del rest
    os.remove(path)
    say("resume-main", chains=N_CHAINS, dim=DIM, steps=f"{CHEES_WARMUP}+{half}+{half}",
        L=fresh._static_L, bit_equal=True, checkpoint_bytes=n_bytes, save_s=f"{save_s:.4f}",
        load_s=f"{load_s:.4f}", resume_wall_s=f"{resume_s:.4f}",
        resume_fill_launches=resume_fills, first_fill_launches=first_fills)
    return dict(fill_launches=first_fills + resume_fills)


class TickRenderer(ProgressRenderer):
    """The progress renderer writing to an in-memory stream, recording every
    update it is given: ``(done, max R-hat, p_accept, view type)``."""

    def __init__(self, n_chains: int, total_steps: int):
        super().__init__(n_chains, total_steps, stream=io.StringIO())
        self.ticks = []

    def update(self, done, tracker=None):
        self.ticks.append((done, tracker.max_rhat(), tracker.p_accept, type(tracker).__name__))
        super().update(done, tracker)


def phase_progress_main(dev, store, chees: dict):
    """The ChEES headline through ``run_progress(3072, 192)``: ``"auto"``
    picks the stream mode (13 GB would be staged); the renderer writes to
    an in-memory stream.  The samples equal "chees-main"'s bit for bit.
    Prints the hook count (3 warmup ticks, 48 collection ticks), the final
    streamed max R-hat and p_accept, the wall beside chees-main's, and the
    device operations a step and busy share of a 10-step collection window
    with the stream tracker (:func:`..core.run_kernel_progress_stream`), to
    set beside "chees-main-window"'s: the difference is the tracker's; and
    PROGRESS_TURN_STEPS of collection from the adapted carry through
    ``run_kernel`` and through the stream runner, in turns."""
    from general_mcmc_torch.samplers import base as base_module

    steps = CHEES_WARMUP + CHEES_COLLECT
    staged = steps * N_CHAINS * DIM * 4
    check(staged > base_module.BatchSampler._AUTO_STREAM_BYTES, "progress-main stages > 64 MiB")
    renderers = []
    real = base_module.ProgressRenderer
    base_module.ProgressRenderer = lambda n, total: renderers.append(TickRenderer(n, total)) \
        or renderers[-1]
    try:
        _, sampler = headline_sampler(dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, stats = sampler.run_progress(CHEES_COLLECT, CHEES_WARMUP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fills = counter_rng.launches
    finally:
        base_module.ProgressRenderer = real
    ticks = renderers[0].ticks
    done = [t[0] for t in ticks]
    want = [64, 128, 192] + [CHEES_WARMUP + 64 * k for k in range(1, CHEES_COLLECT // 64 + 1)]
    check(done == want, f"progress-main ticks at {done[:5]}..., {len(done)} of {len(want)}")
    check({t[3] for t in ticks} == {"_LatestStats"}, "progress-main ran the stream mode")
    check(fills == 2 * steps + 1, f"progress-main: {fills} fill launches == 2 x {steps} + 1")
    check(torch.equal(samples.transpose(0, 1), store), "progress-main samples equal chees-main's")
    t0 = time.perf_counter()
    gmt.RunStats.from_sample(samples)
    stats_s = time.perf_counter() - t0
    last_rhat, last_p = ticks[-1][1], ticks[-1][2]
    check(math.isfinite(last_rhat) and last_rhat < 1.01,
          f"progress-main streamed max R-hat {last_rhat} < 1.01")
    check(stats.rhat.max < 1.01, f"progress-main RunStats max R-hat {stats.rhat.max} < 1.01")
    del samples
    adapted = sampler._final_carry
    static_fn = sampler._static_fn(adapted)
    # PROGRESS_TURN_STEPS of collection from the adapted carry without and
    # with the stream tracker, in turns (plain, stream, stream, plain), one
    # store at a time beside chees-main's
    collect = {
        "plain": lambda: gmt.run_kernel(static_fn, adapted, PROGRESS_TURN_STEPS, 0,
                                        step_offset=CHEES_WARMUP).samples,
        "stream": lambda: gmt.run_kernel_progress_stream(
            static_fn, adapted, PROGRESS_TURN_STEPS, 0, lambda *tick: None).samples,
    }
    turns = {"plain": [], "stream": []}
    for kind in ("plain", "stream", "stream", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect[kind]()
        torch.cuda.synchronize()
        turns[kind].append(time.perf_counter() - t0)
        del out
    stream_over_plain = sum(turns["stream"]) / sum(turns["plain"])
    window = lambda: gmt.run_kernel_progress_stream(static_fn, adapted, CHEES_WINDOW, 0,
                                                    lambda *tick: None)
    window()
    prof = profile_window(window, CHEES_WINDOW, "progress-main-window")
    tracker_ops = (None if prof["ops_per_step"] is None or chees["ops_per_step"] is None
                   else prof["ops_per_step"] - chees["ops_per_step"])
    # the window's one tick (its remainder at its last step) is its only
    # read-back
    check(prof["read_backs"] in (None, 1), f"progress-main window: {prof['read_backs']} "
          "read-backs, the tick's only")
    say("progress-main", chains=N_CHAINS, dim=DIM, steps=f"{CHEES_WARMUP}+{CHEES_COLLECT}",
        mode="stream", staged_gb=f"{staged / 1e9:.2f}", bit_equal=True, hooks=len(ticks),
        warmup_hooks=sum(d <= CHEES_WARMUP for d in done),
        streamed_max_rhat=f"{last_rhat:.5f}", streamed_p_accept=f"{last_p:.5f}",
        runstats_max_rhat=f"{stats.rhat.max:.5f}", wall_s=f"{wall:.4f}",
        runstats_s=f"{stats_s:.4f}", wall_less_runstats_s=f"{wall - stats_s:.4f}",
        chees_main_wall_s=f"{chees['wall']:.4f}",
        wall_over_chees_main=f"{(wall - stats_s) / chees['wall']:.4f}",
        turn_steps=PROGRESS_TURN_STEPS,
        collection_plain_s=json.dumps([round(t, 4) for t in turns["plain"]]),
        collection_stream_s=json.dumps([round(t, 4) for t in turns["stream"]]),
        collection_stream_over_plain=f"{stream_over_plain:.4f}",
        window_ops_per_step="not measured" if prof["ops_per_step"] is None
        else f"{prof['ops_per_step']:.1f}",
        tracker_ops_per_step="not measured" if tracker_ops is None else f"{tracker_ops:.1f}",
        fill_launches=fills)
    return dict(fill_launches=fills)


def phase_rank_main(dev, store, classic_min_ess: float):
    """``rank_normalized_summary`` of "chees-main"'s store (steps-major, on
    the card, parameters a block at a time sized from the free memory):
    max rank-normalized R-hat < 1.01, every ESS finite, the least bulk ESS
    within 0.8–1.25 times the classic least ESS of the same store (on this
    Gaussian both estimate the same thing); on a 64-chain slice the card's
    result equals the same function on the CPU in float64 within rtol
    1e-4.  Prints the seconds, the added peak memory and the minima."""
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rank = gmt.rank_normalized_summary(store, steps_major=True)
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t0
    added_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    max_rhat = float(rank.rhat.max())
    min_bulk, min_tail = float(rank.ess_bulk.min()), float(rank.ess_tail.min())
    check(max_rhat < 1.01, f"rank-main max rank-normalized R-hat {max_rhat} < 1.01")
    check(bool(torch.isfinite(rank.ess_bulk).all() & torch.isfinite(rank.ess_tail).all()),
          "rank-main: every ESS finite")
    ratio = min_bulk / classic_min_ess
    check(RANK_ESS_RATIO[0] <= ratio <= RANK_ESS_RATIO[1],
          f"rank-main: least bulk ESS / classic least ESS {ratio} in {RANK_ESS_RATIO}")
    part = store[:, :RANK_SLICE_CHAINS]
    on_card = gmt.rank_normalized_summary(part, steps_major=True)
    t0 = time.perf_counter()
    on_cpu = gmt.rank_normalized_summary(part.cpu().double(), steps_major=True)
    cpu_s = time.perf_counter() - t0
    rel = max(float(((a.cpu().double() - b) / b).abs().max()) for a, b in zip(on_card, on_cpu))
    check(rel < RANK_RTOL, f"rank-main: the card's {RANK_SLICE_CHAINS}-chain slice against the "
          f"CPU in float64, {rel} < {RANK_RTOL}")
    say("rank-main", draws_per_param=store.shape[0] * store.shape[1], params=store.shape[2],
        seconds=f"{rank_s:.3f}", added_peak_memory_gb=f"{added_gb:.2f}",
        max_rank_rhat=f"{max_rhat:.5f}", min_ess_bulk=f"{min_bulk:.1f}",
        min_ess_tail=f"{min_tail:.1f}", classic_min_ess=f"{classic_min_ess:.1f}",
        bulk_over_classic=f"{ratio:.4f}", slice_chains=RANK_SLICE_CHAINS,
        slice_max_rel_err=f"{rel:.2e}", slice_cpu_f64_s=f"{cpu_s:.2f}")


def phase_nuts_resume(dev, tmp: str):
    """The NUTS leg's sampler at full width (10,240 × 100, cap 4, diagonal
    metric, multinomial proposal) with ``backend="auto"``: ``run(256,
    192)`` against ``run(128, 192)`` + ``save_checkpoint`` + ``resume(128)``
    on the same sampler (as tests/test_nuts_auto.py does), bit for bit,
    ``"static"`` selected by both runs.  256 collected steps, a twelfth of
    "nuts-static"'s, keep the phase to about half a minute."""
    path = f"{tmp}/nuts_auto.npz"
    half = NUTS_RESUME_COLLECT // 2
    t_phase = time.perf_counter()
    reset_counts()
    _, s = nuts_headline(dev, backend="auto")
    want = s.run(NUTS_RESUME_COLLECT, NUTS_WARMUP)
    whole = s.backend_selected
    first = s.run(half, NUTS_WARMUP)
    split = s.backend_selected
    s.save_checkpoint(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest = s.resume(path, half)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    fills = counter_rng.launches
    check(whole == split == "static", f"nuts-resume: auto selected {whole!r} and {split!r}")
    check(torch.equal(torch.cat([first, rest], dim=1), want),
          "nuts-resume: run(128) + checkpoint + resume(128) equals run(256)")
    os.remove(path)
    say("nuts-resume", chains=N_CHAINS, dim=DIM, steps=f"{NUTS_WARMUP}+{half}+{half}",
        backend="auto", backend_selected=whole, bit_equal=True,
        resume_wall_s=f"{resume_s:.4f}", phase_wall_s=f"{time.perf_counter() - t_phase:.2f}",
        fill_launches=fills)
    return dict(fill_launches=fills)


# ---------------------------------------------------------------------------
# MALA, Gibbs, replica exchange and sample export
# ---------------------------------------------------------------------------


def plain_run(sampler, n_collect: int, n_discard: int, draws) -> torch.Tensor:
    """``sampler.run(n_collect, n_discard)`` stepped by hand with the plain
    draws of step ``m``, ``draws(m)`` (keyword arguments of ``_step``),
    computed on the card and injected: ``[n_chains, n_collect, dim]``."""
    carry, kept = sampler._init_carry(), []
    for m in range(n_discard + n_collect):
        carry = sampler._step(carry, m, **draws(m))
        if m >= n_discard:
            kept.append(sampler._positions(carry))
    return torch.stack(kept, dim=1)


def plain_draws(name: str, sampler):
    """``m -> _step`` keyword arguments: the plain draws (the fill kernel's
    plain version) of sampler ``name``'s step ``m``, on its device."""
    key, chains, n = sampler._key, sampler._chain_ids, sampler.n_chains
    dim = sampler._positions(sampler._init_carry()).shape[1]
    ref = lambda cols, m, tag, kind: counter_rng.counter_rng_fill_reference(
        n, cols, key, m, tag, kind, device=sampler.device)
    if name == "hmc":
        return lambda m: dict(z=counter_rng.normals_paired(key, chains, m, dim),
                              u=counter_rng.uniforms(key, chains, m))
    if name in ("mh", "mh_int", "mala"):
        tag = counter_rng.TAG_MALA if name == "mala" else counter_rng.TAG_PROPOSAL
        draw = counter_rng.sign_draws if name == "mh_int" else functools.partial(
            counter_rng.mh_draws, tag=tag)
        return lambda m: dict(zip(("z", "u"), draw(key, chains, m, dim)))
    if name == "tempering":
        t = sampler.n_temps

        def temper(m):
            u = ref(2 * t - 1, m, counter_rng.TAG_TEMPER_UNIFORM, "uniform")
            z = ref(t * dim, m, counter_rng.TAG_TEMPER_NORMAL, "normal_pair")
            return dict(z=z.reshape(n, t, dim), u_acc=u[:, :t], u_swap=u[:, t:])
        return temper
    if name == "gibbs":
        cols = counter_rng.GIBBS_DRAWS * dim
        return lambda m: dict(draws=GibbsDraws(
            ref(cols, m, counter_rng.TAG_GIBBS_NORMAL, "normal_pair"),
            ref(cols, m, counter_rng.TAG_GIBBS_UNIFORM, "uniform")))
    raise ValueError(f"no plain draws for {name!r}")


def k2_bit_check(name: str, sampler, n_collect: int, n_discard: int, fills_per_step: int):
    """``run`` with the fill kernel's draws against :func:`plain_run` with
    the plain draws, ``torch.equal``; the run launches the fill kernel
    ``fills_per_step`` times a step and the plain run not at all.  Returns
    the run's samples and its fill launches."""
    steps = n_discard + n_collect
    before = counter_rng.launches
    got = sampler.run(n_collect, n_discard)
    torch.cuda.synchronize()
    fills = counter_rng.launches - before
    check(fills == fills_per_step * steps,
          f"{name}: {fills} fill launches for {steps} steps ({fills_per_step} a step)")
    want = plain_run(sampler, n_collect, n_discard, plain_draws(name, sampler))
    torch.cuda.synchronize()
    check(counter_rng.launches - before == fills, f"{name}: the plain draws launched no fill")
    check(torch.equal(got, want), f"{name}: the fill kernel's draws and the plain draws give "
          "the same samples bit for bit")
    return got, fills


def moved_share(samples) -> float:
    """Share of a ``[n, collect, dim]`` sample's steps whose coordinate 0
    changed: the accept rate of a continuous proposal."""
    x = samples[:, :, 0]
    return float((x[:, 1:] != x[:, :-1]).float().mean())


def step_window(sampler, label: str, start: int) -> dict:
    """:func:`profile_window` of 50 ``_step`` calls from the sampler's last
    carry, at step indices ``start …``."""
    carry = sampler._final_carry

    def window():
        c = carry
        for m in range(start, start + CHEES_WINDOW):
            c = sampler._step(c, m)

    window()
    return profile_window(window, CHEES_WINDOW, label)


def timed_run(sampler, n_collect: int, n_discard: int):
    """``sampler.run`` from a synchronised start to a synchronised end with
    the fill launches counted from 0: ``(samples, wall_s, fills)``."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = sampler.run(n_collect, n_discard)
    torch.cuda.synchronize()
    return samples, time.perf_counter() - t0, counter_rng.launches


def phase_mala_small(dev):
    """MALA at 256 chains on the 2-d ``GaussianND([1, -2], [1, 2])`` of
    tests/test_mala.py at ε 0.9: the fill kernel's draws bit-equal to the
    plain draws over the whole run, and the JAX test's moment envelopes
    (mean within 0.15, std within 15%)."""
    n = NEW_SMALL_CHAINS
    coll, warm = MALA_SMALL_STEPS
    s = gmt.MALA(gmt.GaussianND([1.0, -2.0], [1.0, 2.0], device=dev),
                 gmt.init_with_seed(n, 2, 4, device=dev), MALA_SMALL_EPS, seed=4)
    reset_counts()
    got, fills = k2_bit_check("mala", s, coll, warm, 1)
    flat = got.reshape(-1, 2).double().cpu()
    want_mean = torch.tensor([1.0, -2.0], dtype=torch.float64)
    want_std = torch.tensor([1.0, 2.0], dtype=torch.float64)
    mean_err = float((flat.mean(0) - want_mean).abs().max())
    std_err = float((flat.std(0) / want_std - 1.0).abs().max())
    check(mean_err < 0.15 and std_err < 0.15,
          f"mala-small moments: mean {mean_err} < 0.15, std {std_err} < 0.15")
    say("mala-small", chains=n, steps=f"{warm}+{coll}", eps=MALA_SMALL_EPS,
        accept=f"{moved_share(got):.4f}", mean_err=f"{mean_err:.4f}",
        std_err=f"{std_err:.4f}", k2_fill_launches=fills, k2_bit_equal=True)
    return dict(fill_launches=fills)


def phase_mala_main(dev):
    """MALA at the headline's width: 10,240 chains of the 100-d unit
    Gaussian from ``init_with_seed(10240, 100, 0)``, ε 0.6, ``run(2000,
    1000)`` (an 8.2 GB store): R-hat, the moments, the accept rate, min-ESS/s
    and grad-evals/s against the run's wall, its fill launches (one a
    step), and the device operations a step and busy share of a 10-step
    window; the fill kernel timed at MALA's shape.  Returns the store for
    "io-main"."""
    coll, warm = MALA_STEPS
    steps = coll + warm
    s = gmt.MALA(gmt.GaussianND(torch.zeros(DIM), torch.ones(DIM), device=dev),
                 gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev), MALA_EPS, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    samples, wall, fills = timed_run(s, coll, warm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(fills == steps, f"mala-main: {fills} fill launches for {steps} steps")
    store = samples.transpose(0, 1)
    check(bool(torch.isfinite(store).all()), "every MALA sample is finite")
    rhat, ess, mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                   return_moments=True)
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    mean_err, std_err = float(mean.abs().max()), float((std - 1.0).abs().max())
    accept = moved_share(samples)
    check(max_rhat < 1.01, f"mala-main max R-hat {max_rhat} < 1.01")
    check(mean_err < 0.05 and std_err < 0.05,
          f"mala-main moments: max|mean| {mean_err} < 0.05, max|std - 1| {std_err} < 0.05")
    prof = step_window(s, "mala-main-window", steps)
    fill = fill_timings(dev, N_CHAINS, {"mh": (DIM + 1, counter_rng.TAG_MALA)})
    say("mala-main", chains=N_CHAINS, dim=DIM, steps=f"{warm}+{coll}", eps=MALA_EPS,
        accept=f"{accept:.4f}", max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}",
        mean_err=f"{mean_err:.5f}", std_err=f"{std_err:.5f}", wall_s=f"{wall:.4f}",
        min_ess_per_s=f"{min_ess / wall:.4e}",
        grad_evals_per_s=f"{N_CHAINS * steps / wall:.4e}", fill_launches=fills,
        host_ms_per_step=f"{wall * 1e3 / steps:.4f}", peak_memory_gb=f"{peak_gb:.2f}",
        fill_mh_ms=f"{fill['mh'][0]:.5f}", fill_mh_bound_ms=f"{fill['mh'][1]:.7f}")
    return dict(fill_launches=fills, fill=fill, store=store)


def phase_io_main(store, tmp: str):
    """Sample export from the card: ``save_csv`` of a 1,024 × 100 × 100 slice
    of "mala-main"'s store through the native writer (MB and MB/s, the copy
    from the card included); a 64 × 100 × 100 slice written and read back
    with numpy, equal to the float64 of the float32 store exactly (the
    writer prints shortest round-trip floats); Arrow and Parquet round
    trips where pyarrow is present, else their ``ImportError``."""
    big = store[:IO_OBS, :IO_CHAINS].transpose(0, 1)  # [chains, obs, dim]
    path = f"{tmp}/mala.csv"
    writes = io_native.writes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmt_io.save_csv(big, path)
    write_s = time.perf_counter() - t0
    check(io_native.writes == writes + 1, "io-main: save_csv went through the native writer")
    mb = os.path.getsize(path) / 1e6
    os.remove(path)

    small = store[:IO_OBS, :IO_CHECK_CHAINS].transpose(0, 1)
    gmt_io.save_csv(small, path)
    back = np.loadtxt(path, delimiter=",", skiprows=1)
    os.remove(path)
    want = small.double().cpu().numpy()
    c, o, d = want.shape
    check(back.shape == (c * o, d + 2), f"io-main: read back {back.shape}")
    check(np.array_equal(back[:, 0], np.repeat(np.arange(c), o))
          and np.array_equal(back[:, 1], np.tile(np.arange(o), c)),
          "io-main: chain and observation columns in chain-major order")
    check(np.array_equal(back[:, 2:].reshape(c, o, d), want),
          "io-main: the CSV reads back to the float64 of the stored float32 exactly")
    try:
        import pyarrow  # noqa: F401
        arrow = "present"
    except ImportError:
        arrow = "absent"
    for name, saver in (("arrow", gmt_io.save_arrow), ("parquet", gmt_io.save_parquet)):
        p = f"{tmp}/mala.{name}"
        if arrow == "present":
            saver(small, p)
            check(np.array_equal(gmt_io.load_table(p), want), f"io-main: {name} round trip")
            os.remove(p)
            continue
        try:
            saver(small, p)
        except ImportError as e:
            check("pyarrow" in str(e), f"io-main: save_{name} raises naming pyarrow ({e})")
        else:
            raise RuntimeError(f"check failed: save_{name} without pyarrow did not raise")
    say("io-main", csv_shape=f"{IO_CHAINS}x{IO_OBS}x{DIM}", csv_values=big.numel(),
        csv_mb=f"{mb:.2f}", csv_s=f"{write_s:.4f}", csv_mb_per_s=f"{mb / write_s:.2f}",
        native_writer=True, library=io_native.library_path().name,
        roundtrip_shape=f"{c}x{o}x{d}", roundtrip_exact=True, pyarrow=arrow)


@dataclasses.dataclass(frozen=True, eq=False)
class MixtureConditional:
    """The reference's two-component mixture (examples/mixture_gibbs.py):
    state ``[x, z]``; ``x | z ~ N(mu_z, sigma_z²)``, ``z | x`` by posterior
    odds, batched for the port's ``(draws, i, state)`` conditional."""

    mu0: float = -2.0
    sigma0: float = 1.0
    mu1: float = 3.0
    sigma1: float = 1.5
    pi0: float = 0.4

    def _pdf(self, x, mu, sigma):
        var = sigma * sigma
        return torch.exp(-((x - mu) ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)

    def sample(self, draws, i, state):
        if i == 0:
            noise = draws.normal(0)
            return torch.where(state[:, 1] < 0.5, self.mu0 + self.sigma0 * noise,
                               self.mu1 + self.sigma1 * noise)
        x = state[:, 0]
        p0 = self.pi0 * self._pdf(x, self.mu0, self.sigma0)
        p1 = (1.0 - self.pi0) * self._pdf(x, self.mu1, self.sigma1)
        total = p0 + p1
        prob_z1 = torch.where(total > 0.0, p1 / total, 0.5)
        return (draws.uniform(0) < prob_z1).to(state.dtype)

    def moments(self):
        """x's mean and variance (gibbs.rs:341-418)."""
        mean = self.pi0 * self.mu0 + (1 - self.pi0) * self.mu1
        var = self.pi0 * (self.sigma0**2 + (self.mu0 - mean) ** 2) + (1 - self.pi0) * (
            self.sigma1**2 + (self.mu1 - mean) ** 2)
        return mean, var


def chain_graph(draws, i, state):
    """tests/test_gibbs.py:111-130: ``x_i | x_{i-1} ~ N(0.5·x_{i-1}, 1)``,
    ``x_0 ~ N(0, 1)``."""
    prev = state[:, i - 1] if i > 0 else 0.0
    return 0.5 * prev + draws.normal(0)


def mixture_inits(n: int, dev):
    return torch.cat([gmt.init_with_seed(n, 1, 1, device=dev),
                      torch.zeros(n, 1, device=dev)], dim=1)


def phase_gibbs_small(dev):
    """Gibbs at 256 chains: the constant and copy conditionals of
    tests/test_gibbs.py:56-83 (every coordinate at the constant; coordinate
    1 sees coordinate 0's value of the same sweep), then the 64-d chain
    graph with the fill kernel's draws bit-equal to the plain draws."""
    n = NEW_SMALL_CHAINS
    const = gmt.GibbsSampler(lambda draws, i, x: torch.full((len(x),), 42.0, device=x.device),
                             gmt.init_with_seed(n, 2, 2, device=dev)).run(10, 5)
    check(bool((const == 42.0).all()), "gibbs-small: the constant conditional")
    copy = gmt.GibbsSampler(lambda draws, i, x: x[:, 0] + 1.0 if i == 0 else x[:, 0],
                            torch.zeros(n, 2, device=dev)).run(3, 0)
    sweeps = torch.tensor([1.0, 2.0, 3.0], device=dev)
    check(bool((copy[:, :, 0] == sweeps).all() and (copy[:, :, 1] == sweeps).all()),
          "gibbs-small: the sweep is sequential (coordinate 1 sees coordinate 0's update)")
    reset_counts()
    coll, warm = GIBBS_SMALL_STEPS
    s = gmt.GibbsSampler(chain_graph, torch.zeros(n, GIBBS_DIM, device=dev), seed=3)
    _, fills = k2_bit_check("gibbs", s, coll, warm, 2)
    say("gibbs-small", chains=n, constant=True, sequential=True, k2_dim=GIBBS_DIM,
        k2_steps=f"{warm}+{coll}", k2_fill_launches=fills, k2_bit_equal=True)
    return dict(fill_launches=fills)


def phase_gibbs_main(dev):
    """The 64-d chain graph (tests/test_gibbs.py:111-130) at 10,240 chains,
    ``run(500, 100)`` (a 1.3 GB store): the middle coordinate's variance
    within 0.05 of 4/3, corr(x₃₀, x₃₁) within 0.03 of 0.5, max R-hat < 1.01;
    the wall, the fill launches (two a step) and a 10-step window; the fill
    kernel timed at Gibbs's shapes."""
    coll, warm = GIBBS_STEPS
    steps = coll + warm
    s = gmt.GibbsSampler(chain_graph, torch.zeros(N_CHAINS, GIBBS_DIM, device=dev), seed=3)
    samples, wall, fills = timed_run(s, coll, warm)
    check(fills == 2 * steps, f"gibbs-main: {fills} fill launches for {steps} steps")
    check(bool(torch.isfinite(samples).all()), "every Gibbs sample is finite")
    mid = samples[:, :, GIBBS_DIM // 2].double()
    var_mid = float(mid.var())
    corr = float(torch.corrcoef(samples[:, :, 30:32].reshape(-1, 2).double().T)[0, 1])
    rhat, _ess = gmt.split_rhat_mean_ess(samples)
    max_rhat = float(rhat.max())
    check(abs(var_mid - 4.0 / 3.0) < 0.05, f"gibbs-main: var x_32 {var_mid} within 0.05 of 4/3")
    check(abs(corr - 0.5) < 0.03, f"gibbs-main: corr(x_30, x_31) {corr} within 0.03 of 0.5")
    check(max_rhat < 1.01, f"gibbs-main max R-hat {max_rhat} < 1.01")
    prof = step_window(s, "gibbs-main-window", steps)
    cols = counter_rng.GIBBS_DRAWS * GIBBS_DIM
    fill = fill_timings(dev, N_CHAINS, {"normal_pair": (cols, counter_rng.TAG_GIBBS_NORMAL),
                                        "uniform": (cols, counter_rng.TAG_GIBBS_UNIFORM)})
    say("gibbs-main", chains=N_CHAINS, dim=GIBBS_DIM, steps=f"{warm}+{coll}",
        var_mid=f"{var_mid:.5f}", corr_30_31=f"{corr:.5f}", max_rhat=f"{max_rhat:.5f}",
        wall_s=f"{wall:.4f}", host_ms_per_step=f"{wall * 1e3 / steps:.4f}",
        fill_launches=fills, fill_normal_pair_ms=f"{fill['normal_pair'][0]:.5f}",
        fill_uniform_ms=f"{fill['uniform'][0]:.5f}")
    return dict(fill_launches=fills, fill=fill, ops_per_step=prof["ops_per_step"])


def phase_gibbs_mixture(dev):
    """The reference's mixture (examples/mixture_gibbs.py) at 10,240
    chains, ``run(5000, 2000)``: x's mean and variance within a tenth of
    theory (tests/test_gibbs.py:99-100)."""
    coll, warm = GIBBS_MIX_STEPS
    cond = MixtureConditional()
    s = gmt.GibbsSampler(cond, mixture_inits(N_CHAINS, dev), seed=42)
    samples, wall, fills = timed_run(s, coll, warm)
    check(fills == 2 * (coll + warm), f"gibbs-mixture: {fills} fill launches")
    x = samples[:, :, 0].double()
    mean, var = float(x.mean()), float(x.var())
    want_mean, want_var = cond.moments()
    check(abs(mean - want_mean) < abs(want_mean) / 10.0,
          f"gibbs-mixture mean {mean} within a tenth of {want_mean}")
    check(abs(var - want_var) < abs(want_var) / 10.0,
          f"gibbs-mixture variance {var} within a tenth of {want_var}")
    say("gibbs-mixture", chains=N_CHAINS, steps=f"{warm}+{coll}", mean=f"{mean:.5f}",
        theory_mean=f"{want_mean:.5f}", var=f"{var:.5f}", theory_var=f"{want_var:.5f}",
        z1_share=f"{float(samples[:, :, 1].double().mean()):.5f}", wall_s=f"{wall:.4f}",
        host_ms_per_step=f"{wall * 1e3 / (coll + warm):.4f}", fill_launches=fills)
    return dict(fill_launches=fills)


def two_wells(x):
    """Equal mixture of N(-4, 0.5²) and N(+4, 0.5²) (examples/
    two_wells_tempering.py), batched."""
    a = -0.5 * rowsum((x + 4.0) * (x + 4.0)) / 0.25
    b = -0.5 * rowsum((x - 4.0) * (x - 4.0)) / 0.25
    return torch.logaddexp(a, b)


def tempering_sampler(n: int, dev, swap_every: int = 1):
    return gmt.ReplicaExchange(two_wells, torch.full((n, 1), -4.0, device=dev),
                               gmt.geometric_temperatures(*TEMPER_LADDER, device=dev),
                               scale=TEMPER_SCALE, swap_every=swap_every, seed=SEED)


def phase_tempering_small(dev):
    """Replica exchange at 256 chains on the two wells: the fill kernel's
    draws bit-equal to the plain draws over the whole run, and the swap
    acceptance of each rung pair (the swaps counted against a copy of the
    sampler whose swap interval no step closes, stepped beside it)."""
    n = NEW_SMALL_CHAINS
    coll, warm = TEMPER_SMALL_STEPS
    s = tempering_sampler(n, dev)
    reset_counts()
    _, fills = k2_bit_check("tempering", s, coll, warm, 2)
    moves_only = tempering_sampler(n, dev, swap_every=10**9)
    draws = plain_draws("tempering", s)
    t = s.n_temps
    tried = torch.zeros(t - 1, device=dev)
    took = torch.zeros(t - 1, device=dev)
    carry = s._init_carry()
    for m in range(coll + warm):
        kw = draws(m)
        mid = moves_only._step(carry, m, **kw)
        carry = s._step(carry, m, **kw)
        active = (torch.arange(t - 1, device=dev) % 2 == m % 2).float()
        tried += active * n
        took += active * (carry[1][:, :-1] != mid[1][:, :-1]).float().sum(0)
    rates = (took / tried).cpu().tolist()
    check(all(0.0 < r < 1.0 for r in rates), f"tempering-small: swap rates {rates}")
    say("tempering-small", chains=n, rungs=t, steps=f"{warm}+{coll}", k2_fill_launches=fills,
        k2_bit_equal=True, swap_accept=json.dumps([round(r, 4) for r in rates]))
    return dict(fill_launches=fills)


def phase_tempering_main(dev):
    """The two wells (examples/two_wells_tempering.py) at 10,240 chains, all
    starting at −4: ``ReplicaExchange(geometric_temperatures(6, 64),
    scale=0.5).run(2000, 300)``; the right well's mass in 0.45–0.55, the
    cold chain's left well mean within 0.05 of −4 and std within 0.05 of
    0.5; the control, ``MetropolisHastings(two_wells,
    IsotropicGaussian(0.5))`` at the same size, keeps the right well's mass
    below 0.05.  The wall, the fill launches (two a step) and a 10-step
    window; the fill kernel timed at replica exchange's shapes."""
    coll, warm = TEMPER_STEPS
    steps = coll + warm
    s = tempering_sampler(N_CHAINS, dev)
    samples, wall, fills = timed_run(s, coll, warm)
    check(fills == 2 * steps, f"tempering-main: {fills} fill launches for {steps} steps")
    x = samples.reshape(-1).double()
    right = float((x > 0).double().mean())
    left = x[x < 0]
    left_mean, left_std = float(left.mean()), float(left.std())
    check(0.45 < right < 0.55, f"tempering-main: right-well mass {right} in 0.45-0.55")
    check(abs(left_mean + 4.0) < 0.05 and abs(left_std - 0.5) < 0.05,
          f"tempering-main: left well mean {left_mean}, std {left_std}")
    prof = step_window(s, "tempering-main-window", steps)
    t = s.n_temps
    fill = fill_timings(dev, N_CHAINS, {
        "normal_pair": (t, counter_rng.TAG_TEMPER_NORMAL),
        "uniform": (2 * t - 1, counter_rng.TAG_TEMPER_UNIFORM)})

    mh = gmt.MetropolisHastings(two_wells, gmt.IsotropicGaussian(TEMPER_SCALE),
                                torch.full((N_CHAINS, 1), -4.0, device=dev), seed=SEED)
    trapped, mh_wall, mh_fills = timed_run(mh, coll, warm)
    check(mh_fills == steps, f"tempering-main control: {mh_fills} fill launches")
    mh_right = float((trapped > 0).double().mean())
    check(mh_right < 0.05, f"tempering-main control: MH right-well mass {mh_right} < 0.05")
    say("tempering-main", chains=N_CHAINS, rungs=t, steps=f"{warm}+{coll}",
        right_mass=f"{right:.5f}", left_mean=f"{left_mean:.5f}", left_std=f"{left_std:.5f}",
        wall_s=f"{wall:.4f}", host_ms_per_step=f"{wall * 1e3 / steps:.4f}",
        fill_launches=fills, mh_right_mass=f"{mh_right:.5f}", mh_wall_s=f"{mh_wall:.4f}",
        mh_fill_launches=mh_fills, fill_normal_pair_ms=f"{fill['normal_pair'][0]:.5f}",
        fill_uniform_ms=f"{fill['uniform'][0]:.5f}")
    return dict(fill_launches=fills + mh_fills, fill=fill, ops_per_step=prof["ops_per_step"])


# -- parallel/: chains (and coordinates) split over ranks -------------------------
# The card is one, so a multi-rank phase runs its ranks as child processes of
# this script (``chip_smoke.py --child <program> ...``) that share the card
# under a gloo group on CUDA tensors (NCCL refuses two ranks on one card);
# "shard-one" is a one-rank NCCL child.  This process never joins a group.
# A child that fails fails its phase.
SHARD_RANKS = 2
# "shard-small": 1,024 chains of the 2-d Gaussian, 10 + 20 steps of each
# sampler with no cross-chain reduction; "shard-dim": a 2 x 2 mesh, 1,024
# chains of a 64-d diagonal Gaussian in float64.
SHARD_SMALL_CHAINS, SHARD_SMALL_STEPS = 1024, (20, 10)
SHARD_SMALL_CASES = ("hmc", "mh", "mala", "tempering", "gibbs", "nuts_torch", "nuts_static")
SHARD_DIM_MESH, SHARD_DIM_D = (2, 2), 64
SHARD_DIM_STEPS = {"nuts": (10, 10), "chees": (20, 20)}
# float64, sums over four column or chain blocks in another order: rounding
SHARD_DIM_ATOL = 1e-8
# "shard-main" against "chees-main": the adapted ε̄ and T in float32 from
# cross-chain means summed in another order
SHARD_ADAPT_RTOL = 1e-3
# warmup steps of the all-reduce probe of "shard-main"
SHARD_PROBE_STEPS = 10
SHARD_CHILD_TIMEOUT = 400
# "shard-dim-odd": the headline target on a 1 x 4 mesh (blocks of 25 from
# columns 0, 25, 50, 75), 1,024 chains in float64; its NUTS has the diagonal
# metric with one window end in the 10 warmup steps, then 4 collected, and
# ChEES 10 + 8 (fewer than "shard-dim"'s: each step's all-reduces over four
# gloo ranks set the phase's time)
SHARD_ODD_MESH, SHARD_ODD_STEPS = (1, 4), {"nuts_diag": (4, 10), "chees": (8, 10)}
SHARD_ODD_WINDOWS = dict(start_buffer=2, end_buffer=2, initial_window=6)
# The trees of the dim phases' NUTS stop at 6 doublings (63 leapfrogs, each
# a round of all-reduces over the gloo ranks): at the default 10 the
# unadapted steps of "shard-dim-odd" took ~3 s each
SHARD_DIM_TREE_DEPTH = 6


def store_digest(store) -> torch.Tensor:
    """``[steps, 2]`` int64 on the CPU: per step, the sum of the store's
    float32 bits as int32 and their sum weighted by the element's index
    modulo 1,021 plus one; two stores that differ in any bit differ here
    but by a coincidence of both sums."""
    steps = store.shape[0]
    w = (torch.arange(store[0].numel(), device=store.device) % 1021 + 1).reshape(
        store.shape[1:])
    out = []
    for k in range(0, steps, 256):
        bits = store[k:k + 256].contiguous().view(torch.int32).to(torch.int64)
        out.append(torch.stack([bits.sum(dim=(1, 2)), (bits * w).sum(dim=(1, 2))], dim=1))
    return torch.cat(out).cpu()


# Ports handed to groups of children so far: phases that run at once
# never share one.
PORTS_TAKEN: set = set()
PORTS_LOCK = threading.Lock()


def free_port() -> int:
    with PORTS_LOCK:
        while True:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            if port not in PORTS_TAKEN:
                PORTS_TAKEN.add(port)
                return port


def spawn_children(program: str, world: int, backend: str, payload: dict, tmp: str):
    """Run ``program`` on ``world`` child ranks of this script (``backend``
    ``"gloo"``, ``"nccl"`` at one rank, or ``"none"``: processes that join
    no group), all on card 0; returns each rank's result and the seconds
    from the start to the last exit.  A child that fails raises here with
    its output; every child is ended."""
    workdir = tempfile.mkdtemp(prefix=f"{program}_", dir=tmp)
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    port = free_port()
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", program,
                               str(port), str(r), str(world), backend, workdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=SHARD_CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{program} rank {r} of {world} exited {p.returncode}:\n"
              f"{log[-6000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(world)], seconds


# This process's rank among the children of its phase (child_main).
CHILD_RANK = 0


def child_main(argv) -> int:
    """One rank of a multi-rank phase: join the group (unless the backend
    is ``"none"``), run the program, write its result."""
    global CHILD_RANK
    program, port, rank, world, backend, workdir = argv
    rank, world = int(rank), int(world)
    CHILD_RANK = rank
    torch.cuda.set_device(0)
    if backend != "none":
        gmt_parallel.initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank, backend=backend,
                                timeout=datetime.timedelta(seconds=300))
    payload = torch.load(os.path.join(workdir, "payload.pt"))
    out = CHILD_PROGRAMS[program](torch.device("cuda", 0), payload)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    if backend != "none":
        torch.distributed.destroy_process_group()
    return 0


def child_shard_main(dev, payload):
    """The ChEES headline through ``run_sharded`` on this rank's half of
    the chains: the gates' inputs (pooled R-hat, the pooled moments, ε̄, T,
    L), the fill launches, the wall of the run and of a second run split by
    phase, and the all-reduces of a warmup step and their host time."""
    scales, sampler = headline_sampler(dev)
    mesh = gmt_parallel.chain_mesh()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = gmt_parallel.run_sharded(sampler, CHEES_COLLECT, CHEES_WARMUP, mesh)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fills = counter_rng.launches
    finite = bool(torch.isfinite(samples).all())
    # per-chain moments in float32, pooled over both ranks in float64
    sm2, mean = torch.var_mean(samples, dim=1)
    rhat = gmt_parallel.pooled_rhat_sharded(mean.double(), sm2.double(), CHEES_COLLECT, mesh)
    n = CHEES_COLLECT
    pooled = torch.stack([mean.double().sum(0), (mean.double() ** 2).sum(0),
                          (sm2.double() * ((n - 1) / n)).sum(0)])
    torch.distributed.all_reduce(pooled, group=mesh.chains_group)
    var = pooled[2] / N_CHAINS + pooled[1] / N_CHAINS - (pooled[0] / N_CHAINS) ** 2
    audit = float((var.sqrt().cpu() / scales.double() - 1.0).abs().max())
    out = dict(shape=tuple(samples.shape), chain0=sampler.shard.chain0, fills=fills,
               finite=finite, max_rhat=float(rhat.max()), audit=audit, L=sampler._static_L,
               eps_bar=float(sampler.adapted_step_size),
               T=float(sampler.adapted_trajectory_length), first_s=first_s,
               divergences=int(sampler.divergences.sum()))
    del samples, sm2, mean
    torch.cuda.empty_cache()
    again = sampler.run(CHEES_COLLECT, CHEES_WARMUP, time_phases=True)
    out["phases"] = dict(sampler.phase_seconds)
    del again
    torch.cuda.empty_cache()

    # the all-reduces of SHARD_PROBE_STEPS warmup steps, each timed on the host
    real, times = torch.distributed.all_reduce, []

    def counted(*args, **kwargs):
        t = time.perf_counter()
        r = real(*args, **kwargs)
        times.append(time.perf_counter() - t)
        return r

    torch.distributed.all_reduce = counted
    try:
        sampler._prepare_run(0, CHEES_WARMUP)
        carry = sampler._init_carry()
        n_init = len(times)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in range(SHARD_PROBE_STEPS):
            carry = sampler._step_fn(carry, m)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
    finally:
        torch.distributed.all_reduce = real
    out.update(init_all_reduces=n_init,
               all_reduces_per_step=(len(times) - n_init) / SHARD_PROBE_STEPS,
               all_reduce_ms_per_step=sum(times[n_init:]) * 1e3 / SHARD_PROBE_STEPS,
               warmup_step_ms=probe_s * 1e3 / SHARD_PROBE_STEPS)
    return out


def child_shard_one(dev, payload):
    """The headline through ``run_sharded`` on a one-rank NCCL mesh: the
    store's digest against chees-main's, and an NCCL all-reduce and
    broadcast on the world group."""
    _, sampler = headline_sampler(dev)
    mesh = gmt_parallel.chain_mesh()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = gmt_parallel.run_sharded(sampler, CHEES_COLLECT, CHEES_WARMUP, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fills = counter_rng.launches
    digest = store_digest(samples.transpose(0, 1))
    probe = torch.full((4,), 3.0, device=dev)
    torch.distributed.all_reduce(probe)
    torch.distributed.broadcast(probe, 0)
    torch.cuda.synchronize()
    return dict(equal=bool(torch.equal(digest, payload["digest"])), fills=fills, wall=wall,
                mesh_size=mesh.size, nccl_probe=probe.cpu().tolist(),
                backend=torch.distributed.get_backend())


def shard_small_sampler(name: str, x0):
    """The "shard-small" samplers on the 2-d Gaussian (autograd), seed 4."""
    t = gmt.DiffableGaussian2D(MH_MEAN, MH_COV, device=x0.device)
    if name == "hmc":
        return gmt.HMC(t, x0, 0.1, 5, seed=4)
    if name == "mh":
        return gmt.MetropolisHastings(t, gmt.RandomWalkProposal(1.0), x0, seed=4)
    if name == "mala":
        return gmt.MALA(t, x0, 0.5, seed=4)
    if name == "tempering":
        return gmt.ReplicaExchange(t, x0, gmt.geometric_temperatures(4, 8.0, device=x0.device),
                                   scale=0.8, seed=4)
    if name == "gibbs":
        return gmt.GibbsSampler(chain_graph, x0, seed=4)
    return gmt.NUTS(t, x0, 0.8, max_tree_depth=NUTS_DEPTH, backend=name[5:], seed=4)


def child_shard_small(dev, payload):
    """Each "shard-small" sampler unsharded and through ``run_sharded``:
    this rank's rows of the first equal to the second, bit for bit; and this
    rank's rows of ``init_positions_on_mesh``."""
    mesh = gmt_parallel.chain_mesh()
    lo, hi = mesh.rows(SHARD_SMALL_CHAINS)
    x0 = gmt.init_with_seed(SHARD_SMALL_CHAINS, 2, 3, device=dev)
    equal, fills = {}, {}
    for name in SHARD_SMALL_CASES:
        whole = shard_small_sampler(name, x0).run(*SHARD_SMALL_STEPS)
        reset_counts()
        block = gmt_parallel.run_sharded(shard_small_sampler(name, x0), *SHARD_SMALL_STEPS,
                                         mesh)
        torch.cuda.synchronize()
        fills[name] = counter_rng.launches
        equal[name] = bool(torch.equal(block, whole[lo:hi]))
    init = gmt_parallel.init_positions_on_mesh(SHARD_SMALL_CHAINS, DIM, 7, mesh, device=dev)
    return dict(rows=(lo, hi), equal=equal, fills=fills, init=init.cpu())


def shard_dim_sampler(name: str, x0, scales=None):
    """NUTS (the dynamic tree; "nuts_diag": with the diagonal metric and
    short windows) or ChEES on the diagonal Gaussian of standard deviations
    ``scales`` (default: "shard-dim"'s ``linspace(1, 3, 64)``), float64."""
    if scales is None:
        scales = torch.linspace(1.0, 3.0, SHARD_DIM_D, dtype=torch.float64)
    target = gmt.GaussianND(torch.zeros_like(scales), scales, device=x0.device)
    if name == "nuts":
        return gmt.NUTS(target, x0, 0.8, seed=11, backend="torch",
                        max_tree_depth=SHARD_DIM_TREE_DEPTH)
    if name == "nuts_diag":
        cfg = gmt.NUTSMassMatrixConfig("diagonal", **SHARD_ODD_WINDOWS)
        return gmt.NUTS(target, x0, 0.8, seed=11, backend="torch", mass_config=cfg,
                        max_tree_depth=SHARD_DIM_TREE_DEPTH)
    return gmt.ChEESHMC(target, x0, seed=11)


def child_shard_dim(dev, payload):
    """NUTS and ChEES on a (chains, dim) mesh with ``shard_dim`` ("shard-dim":
    2 x 2; "shard-dim-odd": 1 x 4 on the headline target, two blocks at an
    odd coordinate): this rank's [rows, columns] block against the unsharded
    run's."""
    mesh = gmt_parallel.make_mesh(*payload["mesh"])
    x0 = payload["x0"].to(dev)
    r0, r1 = mesh.rows(x0.shape[0])
    c0, c1 = mesh.cols(x0.shape[1])
    out = dict(block=(r0, r1, c0, c1))
    for name, steps in payload["steps"].items():
        s = shard_dim_sampler(name, x0, payload.get("scales"))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gmt_parallel.run_sharded(s, *steps, mesh, shard_dim=True)
        torch.cuda.synchronize()
        want = payload[name][r0:r1, :, c0:c1].to(dev)
        out[name] = dict(err=float((got - want).abs().max()), wall=time.perf_counter() - t0,
                         fills=counter_rng.launches,
                         div_equal=bool(torch.equal(s.divergences.cpu(),
                                                    payload[name + "_div"][r0:r1])))
    return out


def phase_shard_main(chees: dict, tmp: str):
    """"shard-main": the ChEES headline on two ranks of the card through
    ``run_sharded`` (5,120 chains a rank): max pooled R-hat < 1.01, the
    pooled moment audit < 0.05, ``L`` equal to chees-main's, ε̄ and T
    within 1e-3 of chees-main's, each rank's fill launches 2 a step + 1."""
    outs, seconds = spawn_children("shard-main", SHARD_RANKS, "gloo", {}, tmp)
    steps = CHEES_WARMUP + CHEES_COLLECT
    for r, o in enumerate(outs):
        check(o["shape"] == (N_CHAINS // SHARD_RANKS, CHEES_COLLECT, DIM) and o["finite"],
              f"shard-main rank {r}: shape {o['shape']} and finite samples")
        check(o["fills"] == 2 * steps + 1, f"shard-main rank {r}: {o['fills']} fill launches")
        check(o["L"] == chees["L"], f"shard-main rank {r}: L {o['L']} == chees-main's "
              f"{chees['L']}")
        for k in ("eps_bar", "T"):
            rel = abs(o[k] / chees[k] - 1.0)
            check(rel < SHARD_ADAPT_RTOL, f"shard-main rank {r}: {k} {o[k]} within "
                  f"{SHARD_ADAPT_RTOL} of chees-main's {chees[k]} ({rel})")
    for k in ("max_rhat", "audit", "eps_bar", "T"):
        check(len({o[k] for o in outs}) == 1, f"shard-main: {k} the same on every rank")
    o = outs[0]
    check(o["max_rhat"] < 1.01, f"shard-main: max pooled R-hat {o['max_rhat']} < 1.01")
    check(o["audit"] < 0.05, f"shard-main: pooled moment audit {o['audit']} < 0.05")
    say("shard-main", ranks=SHARD_RANKS, backend="gloo", chains=N_CHAINS,
        chains_a_rank=N_CHAINS // SHARD_RANKS, steps=f"{CHEES_WARMUP}+{CHEES_COLLECT}",
        L=o["L"], eps_bar=f"{o['eps_bar']:.6f}", T=f"{o['T']:.6f}",
        eps_bar_rel=f"{abs(o['eps_bar'] / chees['eps_bar'] - 1):.3e}",
        T_rel=f"{abs(o['T'] / chees['T'] - 1):.3e}", max_pooled_rhat=f"{o['max_rhat']:.5f}",
        moment_audit=f"{o['audit']:.5f}",
        divergences=sum(x["divergences"] for x in outs),
        fill_launches=json.dumps([x["fills"] for x in outs]),
        first_run_s=json.dumps([round(x["first_s"], 4) for x in outs]),
        wall_split_s=json.dumps([{k: round(v, 4) for k, v in x["phases"].items()}
                                 for x in outs]),
        init_all_reduces=o["init_all_reduces"],
        all_reduces_per_warmup_step=o["all_reduces_per_step"],
        all_reduce_ms_per_warmup_step=json.dumps(
            [round(x["all_reduce_ms_per_step"], 4) for x in outs]),
        warmup_step_ms=json.dumps([round(x["warmup_step_ms"], 4) for x in outs]),
        phase_s=f"{seconds:.2f}")
    return dict(fills=[x["fills"] for x in outs])


def phase_shard_one(chees: dict, tmp: str):
    """"shard-one": the headline through ``run_sharded`` on a one-rank NCCL
    mesh, its store bit-equal (digest) to chees-main's."""
    (o,), seconds = spawn_children("shard-one", 1, "nccl", {"digest": chees["digest"]}, tmp)
    check(o["backend"] == "nccl" and o["mesh_size"] == 1, f"shard-one: {o['backend']} mesh "
          f"of {o['mesh_size']}")
    check(o["equal"], "shard-one: the store equals chees-main's bit for bit (digest)")
    check(o["fills"] == 2 * (CHEES_WARMUP + CHEES_COLLECT) + 1,
          f"shard-one: {o['fills']} fill launches")
    check(o["nccl_probe"] == [3.0] * 4, f"shard-one: NCCL probe {o['nccl_probe']}")
    say("shard-one", backend=o["backend"], digest_equal=True, fill_launches=o["fills"],
        run_s=f"{o['wall']:.4f}", phase_s=f"{seconds:.2f}")
    return dict(fills=o["fills"])


def phase_shard_small(dev, tmp: str):
    """"shard-small": the fill kernel with ``chain0``/``word0`` against the
    plain version's block and timed; then two ranks at 1,024 chains run
    HMC, MH, MALA, replica exchange, Gibbs and NUTS (both trees) through
    ``run_sharded``, each rank's rows bit-equal to the unsharded run's;
    ``init_positions_on_mesh`` the same global array on 1 and 2 ranks.  The
    fill is checked and timed here; returns the function that runs the
    ranks and checks them (it only waits on child processes)."""
    half, cols = N_CHAINS // 2, DIM // 2
    errs = {}
    for kind, tag in (("normal_pair", counter_rng.TAG_MOMENTUM),
                      ("uniform", counter_rng.TAG_TREE), ("bits", counter_rng.TAG_STATIC)):
        want = counter_rng.counter_rng_fill_reference(N_CHAINS, DIM, SEED, 7, tag, kind,
                                                      device=dev)[half:, cols:]
        got = counter_rng.counter_rng_fill(half, cols, SEED, 7, tag, kind, dev, chain0=half,
                                           word0=cols)
        errs[kind] = float((got.double() - want.double()).abs().max())
        check(torch.equal(got, want), f"K2 {kind} fill from chain {half}, word {cols} equals "
              "the plain version's block")
    # the fill at one nonzero (chain0, word0) and unshifted, same shape
    times = {}
    for offsets in ((0, 0), (half, cols)):
        buf = torch.empty((half, cols), dtype=torch.float32, device=dev)
        lib, launch = counter_rng.fill_launcher(buf, SEED, 7, counter_rng.TAG_MOMENTUM,
                                                "normal_pair", *offsets)
        codes = []
        times[offsets] = device_ms(lambda: codes.append(launch()), FILL_REPS)
        _build.check(lib, next((c for c in codes if c), 0), "counter_rng_fill (offset, timed)")
    offset_ms = times[(half, cols)]
    b_ms, b_by = bound(4 * half * cols, half * cols / 4 * PHILOX_OPS + half * cols * 10)

    alone = gmt_parallel.init_positions_on_mesh(SHARD_SMALL_CHAINS, DIM, 7,
                                                gmt_parallel.chain_mesh(), device=dev).cpu()

    def ranks():
        outs, seconds = spawn_children("shard-small", SHARD_RANKS, "gloo", {}, tmp)
        glued = torch.cat([o["init"] for o in outs])
        check(torch.equal(glued, alone), "shard-small: init_positions_on_mesh on 2 ranks "
              "equals 1 rank's")
        steps = sum(SHARD_SMALL_STEPS)
        per_step = {"hmc": 2, "mh": 1, "mala": 1, "tempering": 2, "gibbs": 2, "nuts_torch": 2,
                    "nuts_static": 2}
        for r, o in enumerate(outs):
            differ = [k for k, v in o["equal"].items() if not v]
            check(not differ, f"shard-small rank {r}: rows differ from the unsharded run's "
                  f"for {differ}")
            for name, f in o["fills"].items():
                want = per_step[name] * steps + (1 if name.startswith("nuts") else 0)
                check(f == want, f"shard-small rank {r} {name}: {f} fill launches, not {want}")
        say("shard-small", ranks=SHARD_RANKS, chains=SHARD_SMALL_CHAINS,
            steps="{1}+{0}".format(*SHARD_SMALL_STEPS), samplers=",".join(SHARD_SMALL_CASES),
            rows_bit_equal=True, init_equal=True,
            fill_launches=json.dumps([o["fills"] for o in outs]),
            offset_fill=f"{half}x{cols} from ({half},{cols})", offset_bit_equal=True,
            offset_fill_ms=f"{offset_ms:.5f}", unshifted_fill_ms=f"{times[(0, 0)]:.5f}",
            offset_bound_ms=f"{b_ms:.6f}", phase_s=f"{seconds:.2f}")
        return dict(fills=[sum(o["fills"].values()) for o in outs], offset_ms=offset_ms,
                    unshifted_ms=times[(0, 0)], bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=max(errs.values()))
    return ranks


def dim_phase(label: str, dev, tmp: str, x0, mesh, steps: dict, scales=None):
    """NUTS and ChEES (``steps``: sampler name -> (collected, warmup)) with
    ``shard_dim`` on ``mesh`` in child ranks, each rank's block within
    ``SHARD_DIM_ATOL`` of the unsharded run, its divergences equal; one line
    for ``label``.  The unsharded runs are made here; returns the function
    that runs the ranks, checks them and returns each rank's fill launches
    (it only waits on child processes, so it may run in another thread)."""
    payload = {"x0": x0.cpu(), "mesh": mesh, "steps": steps, "scales": scales}
    walls = {}
    reset_counts()
    for name, st in steps.items():
        s = shard_dim_sampler(name, x0, scales)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload[name] = s.run(*st).cpu()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        payload[name + "_div"] = s.divergences.cpu()
    check(counter_rng.launches > 0, f"{label}: the unsharded runs launched the fill kernel")

    def ranks():
        outs, seconds = spawn_children(label, mesh[0] * mesh[1], "gloo", payload, tmp)
        for r, o in enumerate(outs):
            for name in steps:
                check(o[name]["err"] < SHARD_DIM_ATOL and o[name]["div_equal"],
                      f"{label} rank {r} {name}: max |d| {o[name]['err']} < "
                      f"{SHARD_DIM_ATOL}, divergences equal {o[name]['div_equal']}")
                check(o[name]["fills"] > 0, f"{label} rank {r} {name}: no fill launch")
        say(label, mesh="x".join(map(str, mesh)), chains=x0.shape[0], dim=x0.shape[1],
            dtype="float64", col_starts=json.dumps(sorted({o["block"][2] for o in outs})),
            steps=json.dumps({k: f"{v[1]}+{v[0]}" for k, v in steps.items()}),
            max_abs_err=json.dumps({k: max(o[k]["err"] for o in outs) for k in steps}),
            sharded_wall_s=json.dumps({k: [round(o[k]["wall"], 3) for o in outs]
                                       for k in steps}),
            unsharded_wall_s=json.dumps({k: round(v, 3) for k, v in walls.items()}),
            fill_launches=json.dumps({k: [o[k]["fills"] for o in outs] for k in steps}),
            phase_s=f"{seconds:.2f}")
        return dict(fills=[sum(o[k]["fills"] for k in steps) for o in outs])
    return ranks


def phase_shard_dim(dev, tmp: str):
    """"shard-dim": NUTS (the dynamic tree) and ChEES on a 2 x 2 mesh of
    four ranks with ``shard_dim``, 1,024 chains of a 64-d diagonal Gaussian
    in float64: every rank's block within 1e-8 of the unsharded run."""
    x0 = gmt.init_with_seed(SHARD_SMALL_CHAINS, SHARD_DIM_D, 5, dtype=torch.float64,
                            device=dev)
    return dim_phase("shard-dim", dev, tmp, x0, SHARD_DIM_MESH, SHARD_DIM_STEPS)


def phase_shard_dim_odd(dev, tmp: str):
    """"shard-dim-odd": NUTS (the dynamic tree, the diagonal metric with a
    window end inside the warmup) and ChEES on the 100-d headline target
    on a 1 x 4 mesh, blocks of 25 from columns 0, 25, 50 and 75 (two odd
    starts, whose momentum normals are filled from the even word before),
    1,024 chains in float64, SHARD_ODD_STEPS: every rank's block within
    1e-8 of the unsharded run."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM, dtype=torch.float64))
    x0 = gmt.init_with_seed(SHARD_SMALL_CHAINS, DIM, 5, dtype=torch.float64, device=dev)
    return dim_phase("shard-dim-odd", dev, tmp, x0, SHARD_ODD_MESH, SHARD_ODD_STEPS, scales)


def child_shard_cuda(dev, payload):
    """HMC's and MH's fused backends through ``run_sharded`` on this rank's
    half of the chains at the main paths' shapes: the kernel launches of
    the sharded run (each its block in one launch, rows drawn from
    ``chain0``), and its rows against the same rows of the unsharded single
    launch, bit for bit (``torch.equal``)."""
    mesh = gmt_parallel.chain_mesh()
    out = {}
    for name, make, steps, module in (
            ("hmc", hmc_main_sampler(dev)[-1], (N_COLLECT, N_DISCARD), fused_hmc),
            ("mh", mh_main_sampler(dev)[-1], (MH_COLLECT, MH_DISCARD), fused_mh)):
        sampler = make()
        lo, hi = mesh.rows(sampler.n_chains)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = gmt_parallel.run_sharded(sampler, *steps, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = module.launches
        whole = make().run(*steps)
        out[name] = dict(rows=(lo, hi), launches=launches, wall=wall,
                         shape=tuple(block.shape), chain0=sampler._chain0,
                         equal=bool(torch.equal(block, whole[lo:hi])))
        del block, whole
        torch.cuda.empty_cache()
    return out


def phase_shard_cuda(tmp: str):
    """"shard-cuda": ``HMC(backend="cuda")`` at "main"'s shape (10,240 x
    100, 200 + 1,000 steps) and ``MetropolisHastings(backend="cuda")`` at
    "mh-main"'s (16,384 x 2, 500 + 5,000) through ``run_sharded`` on two
    gloo ranks sharing the card: each rank makes exactly one kernel launch,
    and its rows are bit-equal to the same rows of the unsharded launch."""
    outs, seconds = spawn_children("shard-cuda", SHARD_RANKS, "gloo", {}, tmp)
    for r, o in enumerate(outs):
        for name, n in (("hmc", N_CHAINS), ("mh", MH_CHAINS)):
            k = n // SHARD_RANKS
            check(o[name]["launches"] == 1, f"shard-cuda rank {r} {name}: "
                  f"{o[name]['launches']} kernel launches, not 1")
            check(o[name]["rows"] == (r * k, (r + 1) * k) and o[name]["chain0"] == r * k,
                  f"shard-cuda rank {r} {name}: rows {o[name]['rows']}")
            check(o[name]["equal"], f"shard-cuda rank {r} {name}: rows bit-equal to the "
                  "unsharded launch's")
    say("shard-cuda", ranks=SHARD_RANKS, backend="gloo",
        hmc=f"{N_CHAINS}x{DIM} {N_DISCARD}+{N_COLLECT}",
        mh=f"{MH_CHAINS}x2 {MH_DISCARD}+{MH_COLLECT}", rows_bit_equal=True,
        launches=json.dumps({k: [o[k]["launches"] for o in outs] for k in ("hmc", "mh")}),
        run_s=json.dumps({k: [round(o[k]["wall"], 4) for o in outs] for k in ("hmc", "mh")}),
        phase_s=f"{seconds:.2f}")
    return {k: [o[k]["launches"] for o in outs] for k in ("hmc", "mh")}


# -- the ported examples (examples_torch/) -------------------------------------------------
def load_example(name: str):
    """``examples_torch/<name>.py`` of this checkout, loaded by path (its
    directory last on ``sys.path``: the examples import ``_figure``)."""
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch")
    if directory not in sys.path:
        sys.path.append(directory)
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  os.path.join(directory, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu(t):
    return t.detach().cpu().numpy()


def gate_paths(*paths):
    check(all(os.path.exists(p) for p in paths), f"files written: {paths}")
    return {"files": [os.path.basename(p) for p in paths]}


def gate_regression(out, kw):
    sample, beta_hat, beta_true = out
    p = kw.get("n_features", 8)
    check(tuple(sample.shape) == (kw.get("n_chains", 256), kw.get("n_collect", 300), p + 2),
          f"logistic_nuts shape {tuple(sample.shape)}")
    err = float(abs(beta_hat - beta_true).max())
    strong = abs(beta_true) > 0.5
    signs = bool((beta_hat[strong] > 0).tolist() == (beta_true[strong] > 0).tolist())
    check(err < 1.5 and signs, f"logistic_nuts: max beta error {err} < 1.5, strong signs {signs}")
    return {"max_beta_err": round(err, 4), "strong_signs": signs}


def gate_track(out, kw):
    sample, stats, _ = out
    want = (kw.get("n_chains", 256), kw.get("n_collect", 300), kw.get("n_features", 8))
    check(tuple(sample.shape) == want, f"regression_nc_track shape {tuple(sample.shape)}")
    check(stats.rhat.max < 1.2, f"regression_nc_track R-hat {stats.rhat.max} < 1.2")
    return {"max_rhat": round(stats.rhat.max, 5)}


def gate_custom(out, kw):
    sample, stats = out
    flat = _cpu(sample).reshape(-1, 3)
    mean_err = float(abs(flat.mean(axis=0) - [1.0, -2.0, 3.0]).max())
    var_rel = float(abs(flat.var(axis=0) / [0.5, 2.0, 4.0] - 1.0).max())
    check(mean_err < 0.25 and var_rel < 0.35 and stats.rhat.max < 1.05,
          f"custom_gradient_nuts: mean {mean_err} < 0.25, var {var_rel} < 0.35, R-hat "
          f"{stats.rhat.max} < 1.05")
    return {"mean_err": round(mean_err, 4), "var_rel_err": round(var_rel, 4),
            "max_rhat": round(stats.rhat.max, 5)}


def gate_funnel(out, kw):
    div_coarse, div_adapted, path = out
    check(os.path.exists(path) and div_coarse > div_adapted and div_coarse > 0,
          f"funnel_nuts: divergences {div_coarse} > {div_adapted} and > 0, {path}")
    return {"div_coarse": div_coarse, "div_adapted": div_adapted}


def gate_std(sample, width=16):
    flat = _cpu(sample).reshape(-1, width)
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), width)).numpy()
    rel = float(abs(flat.std(axis=0) / scales - 1.0).max())
    check(rel < 0.12, f"std within 0.12 of the scales ({rel})")
    return {"std_rel_err": round(rel, 4)}


def gate_auto(out, kw):
    worst = {}
    for tag, s in zip("ab", out):
        flat = _cpu(s)[:, 128:, :].reshape(-1, 8)
        m, sd = float(abs(flat.mean(axis=0)).max()), float(abs(flat.std(axis=0) - 1.0).max())
        check(m < 0.3 and sd < 0.25, f"auto_backend_nuts run {tag}: mean {m}, std {sd}")
        worst[tag] = (round(m, 4), round(sd, 4))
    return {"mean_std_err": worst}


def gate_multinomial(out, kw):
    check(set(out) == {"slice", "multinomial"}, f"multinomial_nuts: {set(out)}")
    for rhat_max, min_ess in out.values():
        check(rhat_max < 1.05 and min_ess > 500, f"multinomial_nuts: R-hat {rhat_max}, "
              f"ESS {min_ess}")
    return {k: (round(v[0], 5), round(v[1], 1)) for k, v in out.items()}


def gate_wells(out, kw):
    trapped, mixed = out
    check(trapped < 0.05 and 0.3 < mixed < 0.7, f"two_wells: trapped {trapped}, mixed {mixed}")
    return {"trapped": round(float(trapped), 4), "mixed": round(float(mixed), 4)}


def gate_finite(sample, kw=None):
    check(bool(torch.isfinite(sample).all()), "finite samples")
    return {"shape": list(sample.shape)}


def minimal_nuts_cut(dev):
    """tests/test_examples.py's cut of examples/minimal_nuts.py, whose
    ``main()`` takes no sizes: the example's sampler at 4 chains for 50 +
    50 steps (its ``main()`` is loaded, as the test imports it)."""
    sampler = gmt.NUTS(gmt.Rosenbrock2D(1.0, 100.0), gmt.init_det(4, 2, device=dev), 0.95,
                       device=dev).set_seed(42)
    sample, _ = sampler.run_progress(50, 50, progress=False)
    check(tuple(sample.shape) == (4, 50, 2), f"minimal_nuts cut shape {tuple(sample.shape)}")
    return sample


EXAMPLE_CUTS = {"minimal_nuts": minimal_nuts_cut}


# Each program of examples_torch/ but sharded_nuts ("examples-sharded") with
# the keyword sizes it runs at on the card (None: its own defaults; a dict:
# cut sizes, tests/test_examples.py's where it has them; "cut": a cut in
# EXAMPLE_CUTS of a program whose main() takes no sizes,
# tests/test_examples.py's own where it has one) and the gates of
# tests/test_examples.py.  The dynamic-tree
# programs whose defaults take minutes on the card (NVIDIA H100 80GB HBM3
# at 700 W: minimal_nuts 183.0 s, funnel_nuts 211.7 s; auto_backend_nuts
# 125.0 s; regression_nc_track 86.4 s with the shard phases beside it) run
# cut.  The programs run in EXAMPLE_GROUPS, one process a group, the groups
# at once: the eager paths are host-bound, so the groups share the card and
# take one host core each.  The groups are balanced by a chip run with the
# shard phases beside them (the phase's wall is its slowest group's):
# funnel_nuts (83.6-102.3 s) alone, the other groups below it.
EXAMPLES = {
    "minimal_mh": (None, gate_finite),
    "minimal_hmc": (None, gate_finite),
    "minimal_nuts": ("cut", gate_finite),
    "gauss_mh": (None, lambda out, kw: gate_paths(*out)),
    "rosenbrock_mh": (None, lambda out, kw: gate_paths(out)),
    "rosenbrock3d_hmc": (None, lambda out, kw: gate_paths(out)),
    "static_window_nuts": (None, lambda out, kw: gate_std(out)),
    "multinomial_nuts": (None, gate_multinomial),
    # run(256, 128) cut to run(144, 48): its cap-10 dynamic tree was the
    # slowest program of the phase (90.8 s on an H100 host, the phase's
    # wall); gate_auto reads the 16 collected steps from 128 on.
    "auto_backend_nuts": (dict(n_collect=144, n_warmup=48), gate_auto),
    "chees_hmc": (None, lambda out, kw: gate_std(out)),
    "funnel_nuts": (dict(n_chains=16, dim=6, n_collect=120, n_warmup=200), gate_funnel),
    "logistic_nuts": (None, gate_regression),
    "regression_nc_track": (dict(n_obs=120, n_features=4, n_chains=32, n_collect=150,
                                 n_warmup=150), gate_track),
    "two_wells_tempering": (None, gate_wells),
    "poisson_mh": (None, lambda out, kw: gate_paths(out)),
    "mixture_gibbs": (None, lambda out, kw: gate_paths(out)),
    "custom_gradient_nuts": (None, gate_custom),
}
EXAMPLE_GROUPS = (
    ("funnel_nuts",),
    ("regression_nc_track", "auto_backend_nuts", "minimal_nuts"),
    ("logistic_nuts", "multinomial_nuts", "custom_gradient_nuts", "chees_hmc",
     "static_window_nuts"),
    ("mixture_gibbs", "rosenbrock3d_hmc", "gauss_mh", "poisson_mh", "two_wells_tempering",
     "rosenbrock_mh", "minimal_mh", "minimal_hmc"),
)


def child_examples(dev, payload):
    """This rank's group of EXAMPLE_GROUPS: each program's ``main()`` (or
    its cut) on the card, one after another, each with the counts set to 0
    before it: its wall, fill launches and gates.  A program's own output
    is kept and shown only if it fails.  The process joins no group: a
    program sees the single-process world its user would run it in."""
    os.environ["EXAMPLE_OUT"] = os.path.join(payload["out"], f"rank{CHILD_RANK}")
    out = []
    for name in EXAMPLE_GROUPS[CHILD_RANK]:
        kw, gate = EXAMPLES[name]
        mod = load_example(name)
        log = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
                result = (EXAMPLE_CUTS[name](dev) if kw == "cut"
                          else mod.main(device=dev, **(kw or {})))
            torch.cuda.synchronize()
        except BaseException:
            print(log.getvalue()[-6000:], flush=True)
            raise
        wall = time.perf_counter() - t0
        fills = counter_rng.launches
        check(fills > 0, f"examples {name}: the fill kernel was never launched")
        out.append(dict(name=name, wall=wall, fills=fills, sizes=kw,
                        gates=gate(result, kw if isinstance(kw, dict) else {})))
    return out


def phase_examples(tmp: str):
    """"examples": every ported program but the sharded one on the card
    through its ``main()`` (or tests/test_examples.py's cut), the groups of
    EXAMPLE_GROUPS in child processes at once, each program timed and
    counted on its own: one line each with its wall, gates and fill
    launches."""
    check(sorted(n for g in EXAMPLE_GROUPS for n in g) == sorted(EXAMPLES),
          "every example in one group")
    outs, seconds = spawn_children("examples", len(EXAMPLE_GROUPS), "none",
                                   {"out": os.path.join(tmp, "examples")}, tmp)
    walls, fills = {}, {}
    for group, o in enumerate(outs):
        for r in o:
            walls[r["name"]], fills[r["name"]] = r["wall"], r["fills"]
            kw = r["sizes"]
            sizes = ("default" if kw is None else "cut" if kw == "cut"
                     else json.dumps(kw, separators=(",", ":")))
            say("examples", program=r["name"], group=group, sizes=sizes,
                wall_s=f"{r['wall']:.3f}", fill_launches=r["fills"],
                gates=json.dumps(r["gates"], separators=(",", ":")))
    say("examples-total", programs=len(walls), groups=len(EXAMPLE_GROUPS),
        wall_s=f"{sum(walls.values()):.2f}", phase_s=f"{seconds:.2f}",
        cut=",".join(n for n, (kw, _) in EXAMPLES.items() if kw is not None),
        fill_launches=sum(fills.values()))
    return dict(fills=fills, walls=walls)


def child_examples_sharded(dev, payload):
    """examples_torch/sharded_nuts.py's ``main()`` at its own defaults on
    this rank (the process group is already up: its ``initialize`` is a
    no-op)."""
    mod = load_example("sharded_nuts")
    log = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sample = mod.main()
    torch.cuda.synchronize()
    wall, fills = time.perf_counter() - t0, counter_rng.launches
    rhat, _ = gmt.split_rhat_mean_ess(sample)
    return dict(wall=wall, shape=tuple(sample.shape), fills=fills,
                finite=bool(torch.isfinite(sample).all()), max_rhat=float(rhat.max()),
                device=str(sample.device), backend=torch.distributed.get_backend())


def phase_examples_sharded(tmp: str):
    """"examples-sharded": examples_torch/sharded_nuts.py as one NCCL rank
    (the card's one-card host), at its own defaults: 512 chains, finite,
    every draw a fill launch."""
    (o,), seconds = spawn_children("examples-sharded", 1, "nccl", {}, tmp)
    check(o["backend"] == "nccl" and o["device"].startswith("cuda"),
          f"examples-sharded: {o['backend']} on {o['device']}")
    check(o["shape"][0] == 512 and o["finite"], f"examples-sharded: shape {o['shape']}")
    check(o["fills"] > 0, "examples-sharded: the fill kernel was never launched")
    say("examples-sharded", backend=o["backend"], shape=json.dumps(list(o["shape"])),
        max_split_rhat=f"{o['max_rhat']:.5f}", wall_s=f"{o['wall']:.3f}",
        fill_launches=o["fills"], phase_s=f"{seconds:.2f}")
    return dict(fills=o["fills"], wall=o["wall"])


CHILD_PROGRAMS = {"shard-main": child_shard_main, "shard-one": child_shard_one,
                  "shard-small": child_shard_small, "shard-dim": child_shard_dim,
                  "shard-dim-odd": child_shard_dim, "shard-cuda": child_shard_cuda,
                  "examples": child_examples, "examples-sharded": child_examples_sharded}


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_environment()
    k2 = phase_counter_rng(dev)
    small = phase_small(dev)
    main_path = phase_main_path(dev)
    ident = phase_identity_mass(dev)
    split = phase_k1_split(dev)
    maps = phase_k1_maps(dev)
    mh_small = phase_mh_small(dev)
    mh = phase_mh_main(dev)
    k3_chains = phase_k3_chains(dev)
    k3_widths = phase_k3_widths(dev)
    k1_targets = phase_k1_targets(dev)
    k3_targets = phase_k3_targets(dev)
    wide_eq = phase_wide_equal(dev)
    k1_wide = phase_k1_wide(dev)
    stress = phase_hmc_stress(dev)
    k3_wide = phase_k3_wide(dev)
    torch.cuda.empty_cache()
    dense = phase_dense_main(dev)
    torch.cuda.empty_cache()
    logistic = phase_logistic(dev)
    chees_small = phase_chees_small(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    runtime = phase_runtime_small(dev, tmp)
    chees = phase_chees_main(dev)
    store = chees.pop("store")  # the uninterrupted headline store
    chees["digest"] = store_digest(store)  # "shard-one" holds its store to it
    resumed = phase_resume_main(dev, store, tmp)
    progress = phase_progress_main(dev, store, chees)
    phase_rank_main(dev, store, chees["min_ess"])
    del store
    torch.cuda.empty_cache()
    chees_lg = phase_chees_logistic(dev)
    k1_logistic = phase_k1_logistic(dev, chees_lg)
    torch.cuda.empty_cache()
    k3_logistic = {"nc": phase_k3_logistic(dev, chees_lg, False)}
    torch.cuda.empty_cache()
    k3_logistic["centred"] = phase_k3_logistic(dev, chees_lg, True,
                                               library_ms=k3_logistic["nc"]["library_ms"])
    torch.cuda.empty_cache()
    k1_centred = phase_k1_logistic_centred(dev, chees_lg)
    torch.cuda.empty_cache()
    german = phase_logistic_german(dev)
    torch.cuda.empty_cache()
    wide = phase_logistic_wide(dev)
    torch.cuda.empty_cache()
    nuts_small = phase_nuts_small(dev)
    nuts = phase_nuts_leg(dev, "torch")
    static_small = phase_nuts_static_small(dev)
    static = phase_nuts_leg(dev, "static")
    say("nuts-leg-compare",
        static_over_dynamic_min_ess_per_s=f"{static['min_ess_per_s'] / nuts['min_ess_per_s']:.4f}",
        static_over_dynamic_ms_per_step=f"{static['ms_per_step'] / nuts['ms_per_step']:.4f}")
    nuts_resume = phase_nuts_resume(dev, tmp)
    mala_small = phase_mala_small(dev)
    mala = phase_mala_main(dev)
    phase_io_main(mala.pop("store"), tmp)
    torch.cuda.empty_cache()
    gibbs_small = phase_gibbs_small(dev)
    gibbs = phase_gibbs_main(dev)
    mixture = phase_gibbs_mixture(dev)
    temper_small = phase_tempering_small(dev)
    temper = phase_tempering_main(dev)
    torch.cuda.empty_cache()
    # shard-small's fill, timed with the card to itself, and the unsharded
    # runs of shard-dim and shard-dim-odd: this process's last work on the
    # card.  Then the phases of child processes, three threads of them at
    # once beside this one's three ranked phases in turn (their walls are
    # taken with the others running; the dim phases' gloo rounds slow down
    # as the host's cores run short, so no more run at once)
    small_ranks = phase_shard_small(dev, tmp)
    dim_ranks = phase_shard_dim(dev, tmp)
    odd_ranks = phase_shard_dim_odd(dev, tmp)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(job) for job in (
            lambda: phase_examples(tmp),
            lambda: (phase_shard_main(chees, tmp), phase_shard_cuda(tmp)),
            lambda: (phase_examples_sharded(tmp), phase_shard_one(chees, tmp)))]
        shard_small, shard_dim, shard_odd = small_ranks(), dim_ranks(), odd_ranks()
        examples, (shard, shard_cuda), (examples_sharded, shard_one) = (
            job.result() for job in jobs)
    shutil.rmtree(tmp)
    shard_fills = {"shard-main": shard["fills"], "shard-one": [shard_one["fills"]],
                   "shard-small": shard_small["fills"], "shard-dim": shard_dim["fills"],
                   "shard-dim-odd": shard_odd["fills"]}
    example_fills = {**examples["fills"], "sharded_nuts": examples_sharded["fills"]}
    new_fills = {"mala-main": mala["fill_launches"], "gibbs-main": gibbs["fill_launches"],
                 "gibbs-mixture": mixture["fill_launches"],
                 "tempering-main": temper["fill_launches"]}
    new_fill = {f"mala_mh_{N_CHAINS}x{DIM + 1}": mala["fill"]["mh"]}
    cols = {"gibbs": counter_rng.GIBBS_DRAWS * GIBBS_DIM}
    for name, phase in (("gibbs", gibbs), ("tempering", temper)):
        for kind, v in phase["fill"].items():
            width = cols.get(name, TEMPER_LADDER[0] if kind == "normal_pair"
                             else 2 * TEMPER_LADDER[0] - 1)
            new_fill[f"{name}_{kind}_{N_CHAINS}x{width}"] = v
    runtime_fills = {"runtime-small": runtime["fill_launches"],
                     "resume-main": resumed["fill_launches"],
                     "progress-main": progress["fill_launches"],
                     "nuts-resume": nuts_resume["fill_launches"]}
    kernels = [
        # launches: the main path's one and one a rank of "shard-cuda"
        # (shard_cuda_launches), each counted from 0 around its run
        dict(name="fused_hmc", route="cuda", source="general_mcmc_torch/csrc/fused_hmc.cu",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:116",
             launches=main_path["launches"] + sum(shard_cuda["hmc"]),
             main_path_launches=main_path["launches"], shard_cuda_launches=shard_cuda["hmc"],
             max_abs_err=max(main_path["max_abs_err"], ident["max_abs_err"],
                             small["max_abs_err"]),
             ms=main_path["ms"], plain_ms=main_path["plain_ms"],
             bound_ms=main_path["bound_ms"], bound_by=main_path["bound_by"],
             bound_unfused_ms=main_path["bound_unfused_ms"], library_ms=None,
             split_us={k: round(v, 4) for k, v in split.items()},
             lane_map=maps["chosen"], lane_map_ms=maps["times"],
             # the other targets: each family's run timed beside its plain
             # version ("K1-targets"), the launches of the gate run through HMC
             targets=k1_targets["families"],
             target_launches={"diffable2d": k1_targets["launches"]},
             targets_max_abs_err=k1_targets["max_abs_err"],
             checked_in="K1-small, main, identity-mass, K1-maps, shard-cuda, K1-targets"),
        # K1 on the dense GaussianND: its own tile kernel, the blocked solves'
        # panels on the tensor cores; launches from "dense-main"'s run
        # through HMC; max_abs_err over its checks against the plain version
        # (8 steps at the main shape, small widths); library_ms one
        # torch.cholesky_solve of the residual a leapfrog times the run's
        # leapfrogs; registers and spills from ptxas -v; shared bytes, tiles a
        # block and blocks of the run's launch from the kernel's host code
        dict(name="fused_hmc_dense", route="cuda",
             source="general_mcmc_torch/csrc/fused_hmc_dense.cu",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:116",
             launches=dense["K1"]["launches"],
             max_abs_err=max(dense["K1"]["eq_max_abs_err"],
                             *dense["K1"]["small_max_abs_err"].values()),
             **{k: dense["K1"][k] for k in DENSE_ROW_KEYS},
             checked_in="dense-main"),
        # K3 on the dense GaussianND: its own tile kernel, the forward solve's
        # panels in float32 on the CUDA cores, the draws made by producer
        # warps; launches from "dense-main"'s run through MetropolisHastings;
        # max_abs_err over its checks against the plain version (64 steps at
        # the main shape, small widths with both proposals); library_ms one
        # torch.linalg.solve_triangular of the residual a step times the
        # run's steps; bound_ms the lesser of the CUDA-core and 3 x TF32
        # figures; registers and spills from ptxas -v;
        # shared bytes, L's bytes, tiles and producer warps a block and blocks
        # of the run's launch from the kernel's host code
        dict(name="fused_mh_dense", route="cuda",
             source="general_mcmc_torch/csrc/fused_mh_dense.cu",
             replaces="general_mcmc_tpu/ops/pallas_mh.py:61",
             launches=dense["K3"]["launches"],
             max_abs_err=max(dense["K3"]["eq_max_abs_err"],
                             *dense["K3"]["small_max_abs_err"].values()),
             **{k: dense["K3"][k] for k in DENSE_ROW_KEYS + ("l_bytes", "producer_warps")},
             checked_in="dense-main"),
        # K2 is a device function: on the HMC and MH main paths it runs inside
        # each fused_hmc and fused_mh launch; on the ChEES and NUTS main paths
        # its fill kernel draws every step's momenta and uniforms or words (2
        # launches a step, 1 for the step-size search and, for NUTS, 1 a
        # window end: fill_launches, nuts_fill_launches for the dynamic tree,
        # nuts_static_fill_launches for the static one).  ms, plain_ms and the
        # bound are the fill kernel's at 10,240 x 128 words (phase "K2");
        # runtime_fill_launches: the fill launches of the runtime phases, each
        # counted from 0 over its runs (in launches too);
        # sampler_fill_launches: those of the MALA, Gibbs and replica-exchange
        # main phases (with the MH control's), each counted from 0 (in launches
        # too), and of their small phases' bit checks (not in launches);
        # chees_fill_ms, nuts_fill_ms, nuts_static_fill_ms and sampler_fill_ms
        # at the ChEES, NUTS, MALA, Gibbs and replica-exchange shapes, each
        # with its bound; shard_fill_launches: each rank's fill launches in
        # the parallel phases, counted from 0 in the rank's process
        # (shard-main's in launches too); offset_fill_ms: the fill of a
        # [5120, 50] block of normal pairs from chain 5,120 and word 50, beside
        # the same shape from (0, 0) and its bound; example_fill_launches:
        # each ported example's fill launches ("examples", "examples-sharded"),
        # counted from 0 around its main() (in launches too).
        dict(name="counter_rng", route="cuda",
             source="general_mcmc_torch/csrc/counter_rng.cuh",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:61",
             launches=(main_path["launches"] + mh["launches"] + chees["fill_launches"]
                       + nuts["fill_launches"] + static["fill_launches"]
                       + sum(runtime_fills.values()) + sum(new_fills.values())
                       + sum(shard["fills"]) + sum(example_fills.values())),
             runs_inside="fused_hmc, fused_mh",
             fill_launches=chees["fill_launches"],
             fill_launches_checked=chees_small["fill_launches"],
             nuts_fill_launches=nuts["fill_launches"],
             nuts_fill_launches_checked=nuts_small["fill_launches"],
             nuts_fill_ms={k: v[0] for k, v in nuts["fill"].items()},
             nuts_fill_bound_ms={k: v[1] for k, v in nuts["fill"].items()},
             nuts_static_fill_launches=static["fill_launches"],
             nuts_static_fill_launches_checked=static_small["fill_launches"],
             nuts_static_fill_ms={k: v[0] for k, v in static["fill"].items()},
             nuts_static_fill_bound_ms={k: v[1] for k, v in static["fill"].items()},
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             chees_fill_ms={f"{k}_{N_CHAINS}x{DIM if k == 'normal_pair' else 1}": v[0]
                            for k, v in chees["fill"].items()},
             chees_fill_bound_ms={k: v[1] for k, v in chees["fill"].items()},
             wrapper_call_ms=k2["wrapper_call_ms"],
             runtime_fill_launches=runtime_fills,
             sampler_fill_launches=new_fills,
             sampler_fill_launches_checked={"mala-small": mala_small["fill_launches"],
                                            "gibbs-small": gibbs_small["fill_launches"],
                                            "tempering-small": temper_small["fill_launches"]},
             sampler_fill_ms={k: v[0] for k, v in new_fill.items()},
             sampler_fill_bound_ms={k: v[1] for k, v in new_fill.items()},
             shard_fill_launches=shard_fills,
             example_fill_launches=example_fills,
             offset_fill_ms=shard_small["offset_ms"],
             offset_unshifted_fill_ms=shard_small["unshifted_ms"],
             offset_fill_bound_ms=shard_small["bound_ms"],
             offset_max_abs_err=shard_small["max_abs_err"],
             checked_in="K2, chees-small, chees-main, nuts-small, nuts-main, "
                        "nuts-static-small, nuts-static, runtime-small, resume-main, "
                        "progress-main, nuts-resume, mala-small, mala-main, gibbs-small, "
                        "gibbs-main, gibbs-mixture, tempering-small, tempering-main, "
                        "shard-small, shard-main, shard-one, shard-dim, shard-dim-odd, "
                        "examples, examples-sharded"),
        dict(name="fused_mh", route="cuda", source="general_mcmc_torch/csrc/fused_mh.cu",
             replaces="general_mcmc_tpu/ops/pallas_mh.py:61",
             launches=mh["launches"] + sum(shard_cuda["mh"]),
             main_path_launches=mh["launches"], shard_cuda_launches=shard_cuda["mh"],
             max_abs_err=max(mh["max_abs_err"], mh_small["max_abs_err"]),
             ms=mh["ms"], kernel_only_ms=k3_chains["ms"][MH_CHAINS],
             plain_ms=mh["plain_ms"], bound_ms=mh["bound_ms"], bound_by=mh["bound_by"],
             bound_unfused_ms=mh["bound_unfused_ms"], library_ms=None,
             chains_kernel_only_ms={str(k): v for k, v in k3_chains["ms"].items()},
             widths_ms={str(k): v for k, v in k3_widths["ms"].items()},
             widths_bound_ms={str(k): v for k, v in k3_widths["bound_ms"].items()},
             targets=k3_targets["families"],
             target_launches={"diffable2d": k3_targets["launches"]},
             targets_max_abs_err=k3_targets["max_abs_err"],
             checked_in="K3-small, mh-main, K3-chains, K3-widths, shard-cuda, K3-targets"),
        # K1 and K3 on the wide map (d > 512): launches from "K1-wide"'s two
        # runs and "hmc-stress"'s through HMC, "K3-wide"'s two through
        # MetropolisHastings, each counted from 0 around its run;
        # max_abs_err over "wide-equal" and the full runs against the plain
        # versions (bit for bit); ms, plain_ms and the bound the d = 1,000
        # run's, each case's under "cases" (bound_sms_ms: the bound over
        # the SMs the launch can occupy, a block of a chain's cluster an SM
        # at most); registers and spills of every build from ptxas -v
        dict(name="fused_hmc_wide", route="cuda",
             source="general_mcmc_torch/csrc/fused_hmc_wide.cu",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:116",
             launches=k1_wide["launches"] + stress["launches"],
             max_abs_err=max(wide_eq["max_abs_err"]["K1"], k1_wide["max_abs_err"]),
             **{k: k1_wide["rows"][1000][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "bound_sms_ms")},
             library_ms=None,
             cases={**{f"gaussian_{d}": r for d, r in k1_wide["rows"].items()},
                    f"rosenbrock_{STRESS_DIM}": stress},
             maps={d: m["K1"] for d, m in wide_eq["maps"].items()},
             registers_and_spill_store_bytes=ptxas_report(
                 _build.compile_log.get("fused_hmc_wide", "")),
             checked_in="wide-equal, K1-wide, hmc-stress"),
        dict(name="fused_mh_wide", route="cuda",
             source="general_mcmc_torch/csrc/fused_mh_wide.cu",
             replaces="general_mcmc_tpu/ops/pallas_mh.py:61",
             launches=k3_wide["launches"],
             max_abs_err=max(wide_eq["max_abs_err"]["K3"], k3_wide["max_abs_err"]),
             **{k: k3_wide["rows"][1000][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "bound_sms_ms")},
             library_ms=None,
             cases={f"gaussian_{d}": r for d, r in k3_wide["rows"].items()},
             maps={d: m["K3"] for d, m in wide_eq["maps"].items()},
             registers_and_spill_store_bytes=ptxas_report(
                 _build.compile_log.get("fused_mh_wide", "")),
             checked_in="wide-equal, K3-wide"),
        # no single PyTorch call computes the chain: library_ms is the time of
        # its two torch.matmul a step, alone, times the steps
        dict(name="fused_logistic", route="cuda",
             source="general_mcmc_torch/csrc/fused_logistic.cu",
             replaces="scripts/exp_pallas_logistic.py:57", launches=logistic["launches"],
             max_abs_err=logistic["max_abs_err"],
             max_rel_err={str(k): v for k, v in logistic["rel_err"].items()},
             ms=logistic["ms"], plain_ms=logistic["plain_ms"],
             bound_ms=logistic["bound_ms"], bound_by=logistic["bound_by"],
             bound_cuda_core_ms=logistic["bound_cuda_core_ms"],
             bound_tensor_3xtf32_ms=logistic["bound_tensor_ms"],
             library_ms=logistic["library_ms"],
             checked_in="K4-ragged, K4"),
        # K1 on the stretch line's posterior: its own tile kernel on K4's
        # tile code; launches from "K1-logistic"'s run through HMC;
        # max_abs_err over the chains whose accept decisions agree with the
        # plain version's after 1, 8 and 64 steps; library_ms the two
        # torch.matmul of a leapfrog alone times the run's leapfrogs; bound_ms
        # the tensor cores' (three TF32 passes); registers and spills from
        # ptxas -v; shared bytes, tiles a block and blocks of the run's launch
        # from the kernel's host code
        dict(name="fused_hmc_logistic", route="cuda",
             source="general_mcmc_torch/csrc/fused_hmc_logistic.cu",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:116",
             launches=(k1_logistic["launches"] + k1_centred["launches"]
                       + german["K1_nc"]["launches"] + german["K1_centred"]["launches"]),
             max_abs_err=max(k1_logistic["max_abs_err"], k1_centred["max_abs_err"]),
             max_rel_err={str(k): v for k, v in k1_logistic["rel_err"].items()},
             chains_differ={str(k): v for k, v in k1_logistic["chains_differ"].items()},
             ms=k1_logistic["ms"], plain_ms=k1_logistic["plain_ms"],
             bound_ms=k1_logistic["bound_ms"], bound_by="operations",
             bound_cuda_core_ms=k1_logistic["bound_cuda_core_ms"],
             bound_tensor_3xtf32_ms=k1_logistic["bound_ms"],
             library_ms=k1_logistic["library_ms"], step_size=k1_logistic["eps"],
             registers=k1_logistic["registers"],
             spill_store_bytes=k1_logistic["spill_store_bytes"],
             shared_bytes=k1_logistic["shared_bytes"],
             tiles_a_block=k1_logistic["tiles_a_block"], blocks=k1_logistic["blocks"],
             # the centred HierarchicalLogistic ("K1-logistic-centred"): its
             # launch, errors over the agreeing chains, chains off the float64
             # plain version over seeds 0-3 beside the float32 plain
             # version's own, times and bound (the same shapes)
             centred={k: k1_centred[k] for k in (
                 "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_cuda_core_ms",
                 "library_ms", "accept", "eps", "off_f64_kernel", "off_f64_plain_f32",
                 "registers", "spill_store_bytes")},
             centred_max_rel_err={str(k): v for k, v in k1_centred["rel_err"].items()},
             # the streamed path at German credit's shape ("logistic-german":
             # both targets' runs, gates, times, bounds, X's bytes read and
             # layouts) and at "logistic-wide"'s cases (paths, panels,
             # registers, spills, errors against the plain version)
             german={k: german[f"K1_{k}"] for k in ("nc", "centred")},
             wide={c: {"K1": v["K1"], **{k: {f: v[k][f] for f in (
                 "k1_accept", "k1_differ", "k1_rel_err", "k1_off_f64")}
                 for k in ("nc", "centred")}}
                 for c, v in wide["cases"].items()},
             resident_digest=wide["digests"]["K1"],
             checked_in="K1-logistic, K1-logistic-centred, logistic-german, logistic-wide"),
        # K3 on the stretch line's posterior, both parameterisations: its own
        # tile kernel on tile_mh.cuh and K4's tile code; launches from the two
        # runs through MetropolisHastings (each counted from 0 around its
        # run); max_abs_err over the chains whose accept histories agree
        # with the plain version's (bit-equal); ms, plain_ms, bound and
        # library_ms (one torch.matmul a step alone times the run's steps)
        # the non-centred run's, the centred one's under "centred";
        # registers and spills from ptxas -v (the random walk's
        # instantiation), the layout from the kernel's host code
        dict(name="fused_mh_logistic", route="cuda",
             source="general_mcmc_torch/csrc/fused_mh_logistic.cu",
             replaces="general_mcmc_tpu/ops/pallas_mh.py:61",
             launches=(k3_logistic["nc"]["launches"] + k3_logistic["centred"]["launches"]
                       + german["K3_nc"]["launches"] + german["K3_centred"]["launches"]),
             max_abs_err=0.0, ms=k3_logistic["nc"]["ms"],
             plain_ms=k3_logistic["nc"]["plain_ms"], bound_ms=k3_logistic["nc"]["bound_ms"],
             bound_by="operations", bound_cuda_core_ms=k3_logistic["nc"]["bound_cuda_core_ms"],
             library_ms=k3_logistic["nc"]["library_ms"],
             **{k: k3_logistic["nc"][k] for k in (
                 "accept", "max_rhat", "walk", "chains_differ", "off_f64_kernel",
                 "off_f64_plain_f32", "registers", "spill_store_bytes")},
             **{k: v for k, v in k3_logistic["nc"]["layout"].items() if k != "tiles"},
             centred={k: k3_logistic["centred"][k] for k in (
                 "launches", "ms", "plain_ms", "bound_ms", "library_ms", "accept", "max_rhat",
                 "walk", "chains_differ", "off_f64_kernel", "off_f64_plain_f32", "registers",
                 "spill_store_bytes")},
             german={k: german[f"K3_{k}"] for k in ("nc", "centred")},
             wide={c: {"K3": v["K3"], **{k: {f: v[k][f] for f in ("k3_accept", "k3_differ",
                                                                  "k3_off_f64")}
                                         for k in ("nc", "centred")}}
                   for c, v in wide["cases"].items()},
             resident_digest=wide["digests"]["K3"],
             checked_in="K3-logistic, K3-logistic-centred, logistic-german, logistic-wide"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
