"""Counter-based random draws: Philox4x32-10 addressed by
(seed; chain, step, group, tag).

Port of the in-kernel PRNG of ``general_mcmc_tpu/ops/pallas_hmc.py``
(``seed_prng``, ``_bits``, ``_uniform_01``, ``_standard_normal``).  The
TPU kernel reseeds the core's hardware generator with
``seed + block·num_blocks + step``, which ties its draws to the block size,
and its interpret-mode fallback is a 32-bit murmur3 hash whose inputs
repeat beyond 2³² draws.  Here the device function in
``csrc/counter_rng.cuh`` and the plain version below compute the same
Philox bits from a counter made only of (global chain, absolute step,
dimension group, draw tag), keyed by the seed, so a chain's draws are the
same whatever the batch, launch shape or device.  The bits-to-uniform map
and the Box–Muller cosine branch are the JAX package's; the port also takes
the sine branch of the same two uniforms, an independent normal, so that
one Philox block serves four normals (:func:`box_muller_pair`).

The plain version holds uint32 words in int64 tensors.  A 32×32-bit product
can reach 2⁶⁴ and overflow int64, so the multiplier is split into 16-bit
halves and each partial product stays below 2⁴⁸.

A chain's words at (seed; chain, step, tag) are read as one sequence: word
``w`` is word ``w % 4`` of the block at group ``w // 4``.  Which words each
sampler reads:

- HMC and ChEES-HMC: momentum normals ``2k`` and ``2k + 1`` are the cosine
  and the sine branch of Box–Muller of words ``(2k, 2k + 1)`` under
  ``TAG_MOMENTUM`` (:func:`normals_paired`); the accept uniform is word 0 of
  its own stream, ``TAG_ACCEPT`` (:func:`uniforms`); :func:`step_draws`
  gives both.  ChEES's step-size search draws its momenta the same way
  under ``TAG_EPS_SEARCH`` at step 0 (the JAX package's
  ``fold_in(chain_key, 2**31 - 1)``).
- NUTS: the momenta are HMC's (``TAG_MOMENTUM`` at (seed, chain, step)),
  and the tree's uniforms one word sequence under ``TAG_TREE``: word 0 the
  slice's, words ``1 + 2j`` and ``2 + 2j`` doubling ``j``'s direction and
  swap, and leaf ``i`` of doubling ``j ≥ 1`` word ``1 + 2D + 2^j − 1 + i``
  at doubling cap ``D``, ``1 + 2D + 2^D`` words a step
  (:func:`nuts_draws`; ``ops.tree.TreeDraws.from_uniforms`` reads them).
  The initial step-size search draws its momenta as ChEES's does
  (``TAG_EPS_SEARCH`` at step 0); the re-search at the end of a metric
  window at step ``m`` under ``TAG_EPS_WINDOW`` at step ``m`` (the JAX
  package's ``fold_in(step_key, 2**31 - 2)``).
- NUTS's static tree at doubling cap ``J``: the momenta are HMC's, and the
  rest one word sequence under ``TAG_STATIC``, ``2 + 2J`` raw words a step
  (:func:`static_draws`; ``ops.static_tree.StaticDraws.from_words`` reads
  them): word 0's uniform gives the slice's Exp(1), ``−log(u₀)`` (finite
  at every word; the law of the JAX package's draw), in both proposal
  modes; word 1's top ``J``
  bits the window offset ``o``, exactly uniform on ``{0, …, 2^J − 1}`` as
  JAX's ``randint(0, 2^J)``; words ``2 … J + 1`` give ``u_sel`` and
  ``J + 2 … 2J + 1`` ``u_swap``, one uniform a doubling each.  The offset
  is read from the word and not from its uniform: in float32 the uniform
  of a word in the upper half rounds to an even multiple of 2⁻²⁴, which
  merges two words, so ``floor(u·2^J)`` would move a word across a block
  boundary and reach ``2^J`` at the top word.
- MH: the proposal normals are the same pairs under ``TAG_PROPOSAL``, and
  the next word, ``2·⌈dim/2⌉``, gives the accept uniform
  (:func:`mh_draws`): at dim 2 one block a step, words 0 and 1 for the
  normals and word 2 for the uniform.  The discrete walk reads its own
  stream, ``TAG_SIGN``: the sign of coordinate ``j`` is the top bit of word
  ``j`` and the accept uniform is word ``dim`` (:func:`sign_draws`).  The
  ``"torch"`` step draws both with one fill launch (:func:`walk_draws`,
  :func:`sign_walk_draws`).
- MALA: MH's layout under its own tag, ``TAG_MALA``: the ``dim`` proposal
  normals from the pairs and the accept uniform from word ``2·⌈dim/2⌉``
  (:func:`walk_draws` with ``tag=TAG_MALA``), one fill launch a step.
- Replica exchange over ``T`` rungs: the proposal normals of every rung
  from one pair stream under ``TAG_TEMPER_NORMAL``, ``T·dim`` normals with
  rung ``t``'s coordinates at ``t·dim … t·dim + dim − 1``; and ``2T − 1``
  uniforms from one word sequence under ``TAG_TEMPER_UNIFORM``, words ``0 …
  T − 1`` the rungs' accepts and words ``T … 2T − 2`` the adjacent pairs'
  swaps (:func:`tempering_draws`), two fill launches a step.
- Gibbs: coordinate ``i`` owns group ``i`` (one Philox block) of a pair
  stream under ``TAG_GIBBS_NORMAL`` and of a word sequence under
  ``TAG_GIBBS_UNIFORM``: normals ``4i … 4i + 3`` and uniforms ``4i … 4i +
  3``, so a conditional may take up to four of each, and no normal shares a
  word with a uniform (:func:`gibbs_draws`), two fill launches a step
  whatever ``dim`` is.
- Initial positions on a mesh (``parallel.init_positions_on_mesh``): chain
  ``c``'s ``dim`` coordinates are the pairs of ``(seed; c, 0, ·,
  TAG_INIT)``.

Every draw is addressed by the *global* chain and word.  A fill of ``n``
rows from ``chain0`` and ``n_words`` columns from ``word0`` gives rows
``chain0 … chain0 + n − 1`` and columns ``word0 … word0 + n_words − 1`` of
the unsharded fill, so a rank that holds a block of chains (and, on the dim
axis, of coordinates) draws exactly its block of the unsharded draws.  The
momentum normals of a coordinate block take its first column as ``word0``;
the fill kernel draws normal pairs only from an even word, so a block that
starts at an odd coordinate is filled from ``word0 − 1`` with one column
more and its leading column dropped (:func:`counter_rng_fill` and its plain
version), as :func:`_words` drops the words before ``word0`` in its first
block.  The per-chain uniforms and tree words are the chain's own, the same
on every rank of a dim group.  With both offsets 0 every stream is the one
it always was.  A block of columns ``col0 … col0 + k − 1`` of a row of
``d_total`` coordinates draws:

- HMC, ChEES and NUTS: its momentum normals from word ``col0``
  (``word0`` of :func:`step_draws`, :func:`nuts_draws`,
  :func:`static_draws`);
- MH's walk and pCN, and MALA (the ``"mh"`` layout): its normals as pairs
  from word ``col0``, and the whole row's accept uniform from word
  ``2·⌈d_total/2⌉``, two fills (:func:`walk_draws` with ``word0`` and
  ``d_total``);
- the sign walk: its ``k`` raw words from word ``col0`` and the whole
  row's uniform word ``d_total``, two fills (:func:`sign_walk_draws`);
- replica exchange: rung ``t``'s normals from word ``t·d_total + col0``,
  one fill a rung (:func:`tempering_draws` with ``word0`` and
  ``d_total``).

Gibbs has no block draws: its sweep is gathered, and every rank of the dim
group draws whole rows (:func:`gibbs_draws`).

The tags are the same numbers as ``kTag*`` in ``csrc/counter_rng.cuh``,
but for ``TAG_STATIC`` and the tags after it, which have no constant there:
they reach the card only as the fill kernel's argument.

``counter_rng_fill`` launches the fill kernel of ``csrc/counter_rng.cu``,
which writes the device function's draws to a tensor.  Every eager sampler
draws with it on the card (:func:`step_draws`, :func:`walk_draws`,
:func:`sign_walk_draws`, :func:`nuts_draws`, :func:`static_draws`,
:func:`tempering_draws`, :func:`gibbs_draws`); the fused HMC and MH kernels
run the device function inside themselves.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "TAG_MOMENTUM",
    "TAG_ACCEPT",
    "TAG_PROPOSAL",
    "TAG_SIGN",
    "TAG_EPS_SEARCH",
    "TAG_TREE",
    "TAG_EPS_WINDOW",
    "TAG_STATIC",
    "TAG_MALA",
    "TAG_TEMPER_NORMAL",
    "TAG_TEMPER_UNIFORM",
    "TAG_GIBBS_NORMAL",
    "TAG_GIBBS_UNIFORM",
    "TAG_INIT",
    "GIBBS_DRAWS",
    "philox4x32_10",
    "counter_bits",
    "bits_to_uniform",
    "box_muller_pair",
    "normals_paired",
    "uniforms",
    "mh_draws",
    "sign_draws",
    "step_draws",
    "walk_draws",
    "sign_walk_draws",
    "tempering_draws",
    "gibbs_draws",
    "nuts_draws",
    "tree_words",
    "static_words",
    "static_draws",
    "words_to_uniform",
    "counter_rng_fill",
    "counter_rng_fill_reference",
    "fill_launcher",
    "curand_check",
    "pair_sweep",
    "launches",
]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586

TAG_MOMENTUM = 0
TAG_ACCEPT = 1
TAG_PROPOSAL = 2
TAG_SIGN = 3
TAG_EPS_SEARCH = 4
TAG_TREE = 5
TAG_EPS_WINDOW = 6
TAG_STATIC = 7
TAG_MALA = 8
TAG_TEMPER_NORMAL = 9
TAG_TEMPER_UNIFORM = 10
TAG_GIBBS_NORMAL = 11
TAG_GIBBS_UNIFORM = 12
TAG_INIT = 13

# Normals, and uniforms, a Gibbs coordinate may draw in one sweep: one
# Philox block of each stream.
GIBBS_DRAWS = 4

# Launches of the fill kernel (counter_rng_fill) in this process.
launches = 0

_KINDS = {"bits": 0, "uniform": 1, "mh": 2, "normal_pair": 3}


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of ``m·c`` for a constant uint32 ``m`` and a
    tensor of uint32 values held in int64."""
    t = c * (m & 0xFFFF)  # < 2^48
    s = c * (m >> 16) + (t >> 16)  # < 2^48 + 2^32
    hi = s >> 16
    lo = ((s & 0xFFFF) << 16) | (t & 0xFFFF)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Random123's Philox4x32-10 on int64 tensors of uint32 counter words
    (broadcast together) under the key ``(k0, k1)``; returns four int64
    tensors of uint32 words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3))
    )
    k0 &= _MASK
    k1 &= _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter_bits(seed: int, chains, step, groups, tag: int) -> torch.Tensor:
    """The four words of each (chain, step, group) counter under ``seed``
    and ``tag``: ``[*broadcast shape, 4]`` int64 holding uint32 values."""
    chains = torch.as_tensor(chains, dtype=torch.int64)
    groups = torch.as_tensor(groups, dtype=torch.int64, device=chains.device)
    step = torch.as_tensor(step, dtype=torch.int64, device=chains.device)
    w = philox4x32_10(chains, step, groups, torch.full_like(step, tag), seed)
    return torch.stack(w, dim=-1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Uniform from 32 random bits (JAX ``_uniform_01``): the top 24 bits
    times 2⁻²⁴ plus 2⁻²⁵, in float32.  Never 0; the top value rounds to 1.0
    in float32, as it does in the JAX package."""
    return (bits >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def box_muller_pair(b1: torch.Tensor, b2: torch.Tensor):
    """Two independent normals from two words: the cosine branch (JAX
    ``_standard_normal``) and the sine branch of the same radius and
    angle."""
    u1 = bits_to_uniform(b1)
    u2 = bits_to_uniform(b2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = _TWO_PI * u2
    return r * torch.cos(angle), r * torch.sin(angle)


def _words(seed: int, chains: torch.Tensor, step: int, n_words: int,
           tag: int, word0: int = 0) -> torch.Tensor:
    """``[n_chains, ≥ n_words]`` int64: each chain's word sequence at
    (seed; chain, step, tag) from word ``word0`` to the end of the block that
    holds word ``word0 + n_words − 1``."""
    groups = torch.arange(word0 >> 2, (word0 + n_words + 3) >> 2, dtype=torch.int64,
                          device=chains.device)
    w = counter_bits(seed, chains[:, None], step, groups[None, :], tag)
    return w.reshape(chains.shape[0], -1)[:, word0 & 3:]


def _paired(w: torch.Tensor, dim: int) -> torch.Tensor:
    """Normals ``2k`` and ``2k + 1`` from the cosine and sine branch of words
    ``(2k, 2k + 1)`` of the word sequences ``w``, ``k < ⌈dim/2⌉``."""
    pairs = (dim + 1) // 2
    z_cos, z_sin = box_muller_pair(w[:, 0:2 * pairs:2], w[:, 1:2 * pairs:2])
    return torch.stack([z_cos, z_sin], dim=-1).reshape(w.shape[0], -1)[:, :dim]


def normals_paired(seed: int, chains: torch.Tensor, step: int, dim: int,
                   tag: int = TAG_MOMENTUM) -> torch.Tensor:
    """``[n_chains, dim]`` float32 standard normals, four from each Philox
    block: normals ``2k`` and ``2k + 1`` are the cosine and sine branch of
    words ``(2k, 2k + 1)`` — so normals ``4q`` to ``4q + 3`` come from group
    ``q`` — the fused HMC kernel's momentum layout."""
    return _paired(_words(seed, chains, step, dim, tag), dim)


def uniforms(seed: int, chains: torch.Tensor, step: int,
             tag: int = TAG_ACCEPT) -> torch.Tensor:
    """``[n_chains]`` float32 uniforms: word 0 of group 0."""
    w = counter_bits(seed, chains, step, 0, tag)
    return bits_to_uniform(w[..., 0])


def mh_draws(seed: int, chains: torch.Tensor, step: int, dim: int,
             tag: int = TAG_PROPOSAL):
    """MH's draws for one step: ``z [n_chains, dim]`` float32 standard
    normals and ``u [n_chains]`` float32 uniforms.  Normals ``2k`` and
    ``2k + 1`` are the cosine and sine branch of words ``(2k, 2k + 1)`` (the
    layout of :func:`normals_paired`), and ``u`` is word ``2·⌈dim/2⌉``."""
    n_z = 2 * ((dim + 1) // 2)
    w = _words(seed, chains, step, n_z + 1, tag)
    return _paired(w, dim), bits_to_uniform(w[:, n_z])


def sign_draws(seed: int, chains: torch.Tensor, step: int, dim: int,
               tag: int = TAG_SIGN):
    """The discrete walk's draws for one step: ``up [n_chains, dim]`` fair
    coin flips (bool), flip ``j`` the top bit of word ``j``, and
    ``u [n_chains]`` float32 uniforms from word ``dim``."""
    w = _words(seed, chains, step, dim + 1, tag)
    return (w[:, :dim] >> 31) == 1, bits_to_uniform(w[:, dim])


def step_draws(seed: int, n_chains: int, step: int, dim: int, device=None, chain0: int = 0,
               word0: int = 0):
    """One HMC or ChEES step's draws for chains ``chain0 … chain0 + n_chains
    − 1``: ``z [n_chains, dim]`` momentum normals (:func:`normals_paired`,
    columns from ``word0``) and ``u [n_chains]`` accept uniforms
    (:func:`uniforms`), float32.  On a CUDA device they are two launches of
    the fill kernel, on the CPU the plain version (:func:`counter_rng_fill`);
    both give the same bits."""
    z = counter_rng_fill(n_chains, dim, seed, step, TAG_MOMENTUM, "normal_pair", device,
                         chain0, word0)
    u = counter_rng_fill(n_chains, 1, seed, step, TAG_ACCEPT, "uniform", device, chain0)
    return z, u[:, 0]


def _is_block(dim: int, word0: int, d_total) -> bool:
    """Whether ``dim`` columns from ``word0`` are a block of a wider row of
    ``d_total`` coordinates (``None``: the row is the block)."""
    return word0 != 0 or (d_total is not None and d_total != dim)


def walk_draws(seed: int, n_chains: int, step: int, dim: int, tag: int = TAG_PROPOSAL,
               device=None, chain0: int = 0, word0: int = 0, d_total: int | None = None):
    """One step's draws of :func:`mh_draws` for chains ``chain0 … chain0 +
    n_chains − 1``: ``z [n_chains, dim]`` normals and ``u [n_chains]``
    uniforms, float32, from one fill launch of kind ``"mh"`` on a CUDA device
    (the plain version on the CPU).  MH's normal proposals draw under
    ``TAG_PROPOSAL``, MALA under ``TAG_MALA``.  A block of columns from
    ``word0`` of a row of ``d_total`` coordinates draws its normals from
    word ``word0`` and the row's uniform from word ``2·⌈d_total/2⌉``: two
    fills, the unsharded draws' columns bit for bit."""
    if _is_block(dim, word0, d_total):
        z = counter_rng_fill(n_chains, dim, seed, step, tag, "normal_pair", device, chain0,
                             word0)
        u = counter_rng_fill(n_chains, 1, seed, step, tag, "uniform", device, chain0,
                             2 * ((d_total + 1) // 2))
        return z, u[:, 0]
    w = counter_rng_fill(n_chains, dim + 1, seed, step, tag, "mh", device, chain0)
    return w[:, :dim], w[:, dim]


def sign_walk_draws(seed: int, n_chains: int, step: int, dim: int, device=None,
                    chain0: int = 0, word0: int = 0, d_total: int | None = None):
    """One step's draws of :func:`sign_draws` for chains ``chain0 … chain0 +
    n_chains − 1``: ``up [n_chains, dim]`` coin flips (bool) and ``u
    [n_chains]`` float32 uniforms, from one fill launch of ``dim + 1`` raw
    words under ``TAG_SIGN`` on a CUDA device (the plain version on the
    CPU).  A block of columns from ``word0`` of a row of ``d_total``
    coordinates fills its words from ``word0`` and the row's uniform word
    ``d_total``: two fills."""
    if _is_block(dim, word0, d_total):
        w = counter_rng_fill(n_chains, dim, seed, step, TAG_SIGN, "bits", device, chain0, word0)
        w_u = counter_rng_fill(n_chains, 1, seed, step, TAG_SIGN, "bits", device, chain0,
                               d_total)
        return w < 0, words_to_uniform(w_u[:, 0])
    w = counter_rng_fill(n_chains, dim + 1, seed, step, TAG_SIGN, "bits", device, chain0)
    return w[:, :dim] < 0, words_to_uniform(w[:, dim])  # int32 < 0: the top bit


def tempering_draws(seed: int, n_chains: int, step: int, n_temps: int, dim: int,
                    device=None, chain0: int = 0, word0: int = 0,
                    d_total: int | None = None):
    """One replica-exchange step's draws for chains ``chain0 … chain0 +
    n_chains − 1`` over ``n_temps`` rungs (layout in the module docstring):
    ``z [n_chains, n_temps, dim]`` proposal normals, ``u_acc [n_chains,
    n_temps]`` accept uniforms and ``u_swap [n_chains, n_temps − 1]`` swap
    uniforms, float32.  On a CUDA device two fill launches, on the CPU the
    plain version.  A block of columns from ``word0`` of a row of
    ``d_total`` coordinates fills rung ``t``'s normals from word ``t·d_total
    + word0``: one fill a rung, then the uniforms'."""
    if _is_block(dim, word0, d_total):
        z = torch.stack([counter_rng_fill(n_chains, dim, seed, step, TAG_TEMPER_NORMAL,
                                          "normal_pair", device, chain0, t * d_total + word0)
                         for t in range(n_temps)], dim=1)
    else:
        z = counter_rng_fill(n_chains, n_temps * dim, seed, step, TAG_TEMPER_NORMAL,
                             "normal_pair", device, chain0).reshape(n_chains, n_temps, dim)
    u = counter_rng_fill(n_chains, 2 * n_temps - 1, seed, step, TAG_TEMPER_UNIFORM,
                         "uniform", device, chain0)
    return z, u[:, :n_temps], u[:, n_temps:]


def gibbs_draws(seed: int, n_chains: int, step: int, dim: int, device=None,
                chain0: int = 0):
    """One Gibbs sweep's draws for chains ``chain0 … chain0 + n_chains − 1``:
    ``normals`` and ``uniforms``, each ``[n_chains, GIBBS_DRAWS·dim]``
    float32, columns ``4i … 4i + 3`` coordinate ``i``'s (layout in the module
    docstring).  On a CUDA device two fill launches, on the CPU the plain
    version."""
    cols = GIBBS_DRAWS * dim
    normals = counter_rng_fill(n_chains, cols, seed, step, TAG_GIBBS_NORMAL, "normal_pair",
                               device, chain0)
    uniforms = counter_rng_fill(n_chains, cols, seed, step, TAG_GIBBS_UNIFORM, "uniform",
                                device, chain0)
    return normals, uniforms


def tree_words(depth: int) -> int:
    """Uniforms a chain draws for one dynamic-tree transition at doubling
    cap ``depth``: the slice's, two a doubling and ``2^depth`` leaf
    columns."""
    return 1 + 2 * depth + (1 << depth)


def nuts_draws(seed: int, n_chains: int, step: int, dim: int, depth: int, device=None,
               chain0: int = 0, word0: int = 0):
    """One NUTS step's draws for chains ``chain0 … chain0 + n_chains − 1`` at
    doubling cap ``depth``: ``z [n_chains, dim]`` momentum normals
    (:func:`normals_paired` under ``TAG_MOMENTUM``, columns from ``word0``)
    and ``u [n_chains, tree_words(depth)]`` the tree's uniforms
    (``TAG_TREE``; layout in the module docstring), float32.  On a CUDA
    device they are two launches of the fill kernel, on the CPU the plain
    version; both give the same bits."""
    z = counter_rng_fill(n_chains, dim, seed, step, TAG_MOMENTUM, "normal_pair", device,
                         chain0, word0)
    u = counter_rng_fill(n_chains, tree_words(depth), seed, step, TAG_TREE, "uniform", device,
                         chain0)
    return z, u


def static_words(depth: int) -> int:
    """Words a chain draws under ``TAG_STATIC`` for one static-tree
    transition at doubling cap ``depth``: the slice's, the offset's and two
    a doubling."""
    return 2 + 2 * depth


def static_draws(seed: int, n_chains: int, step: int, dim: int, depth: int, device=None,
                 chain0: int = 0, word0: int = 0):
    """One static-tree NUTS step's draws for chains ``chain0 … chain0 +
    n_chains − 1`` at doubling cap ``depth``: ``z [n_chains, dim]`` float32
    momentum normals (:func:`normals_paired` under ``TAG_MOMENTUM``, columns
    from ``word0``) and ``w [n_chains, static_words(depth)]`` the raw words
    under ``TAG_STATIC`` (int32 holding uint32 bits; layout in the module
    docstring).  On a CUDA device they are two launches of the fill kernel,
    on the CPU the plain version; both give the same bits."""
    z = counter_rng_fill(n_chains, dim, seed, step, TAG_MOMENTUM, "normal_pair", device,
                         chain0, word0)
    w = counter_rng_fill(n_chains, static_words(depth), seed, step, TAG_STATIC, "bits", device,
                         chain0)
    return z, w


def words_to_uniform(w: torch.Tensor) -> torch.Tensor:
    """:func:`bits_to_uniform` of int32 words holding uint32 bits (the fill
    kernel's ``"bits"``)."""
    return bits_to_uniform(w.to(torch.int64) & _MASK)


def _check_fill(n_words: int, kind: str, chain0: int, word0: int) -> None:
    """Raise on a fill the kernel does not take."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "mh" and n_words < 2:
        raise ValueError("the mh layout needs n_words = dim + 1 >= 2")
    if not (0 <= chain0 <= _MASK and 0 <= word0 <= _MASK):
        raise ValueError(f"chain0 and word0 must be uint32, got {chain0} and {word0}")
    if kind == "mh" and word0:
        raise ValueError("the mh layout's uniform follows the whole row's normals: "
                         "word0 must be 0")
    if kind == "normal_pair" and word0 % 2:
        raise ValueError(f"the fill kernel starts normal pairs at an even word, got "
                         f"word0={word0}")


def _odd_pair_start(kind: str, word0: int) -> bool:
    """Whether a fill of normal pairs starts at an odd word: it is then
    filled from ``word0 − 1`` with one column more, and that column
    dropped."""
    return kind == "normal_pair" and word0 % 2 == 1


def counter_rng_fill_reference(n_chains: int, n_words: int, seed: int, step: int,
                               tag: int, kind: str = "bits", device=None,
                               chain0: int = 0, word0: int = 0) -> torch.Tensor:
    """Plain version of :func:`counter_rng_fill`."""
    if _odd_pair_start(kind, word0):
        return counter_rng_fill_reference(n_chains, n_words + 1, seed, step, tag, kind,
                                          device, chain0, word0 - 1)[:, 1:].contiguous()
    _check_fill(n_words, kind, chain0, word0)
    chains = (torch.arange(n_chains, dtype=torch.int64, device=device) + chain0) & _MASK
    if kind == "mh":
        z, u = mh_draws(seed, chains, step, n_words - 1, tag)
        return torch.cat([z, u[:, None]], dim=1)
    if kind == "normal_pair":
        return _paired(_words(seed, chains, step, n_words, tag, word0), n_words)
    bits = _words(seed, chains, step, n_words, tag, word0)[:, :n_words]
    if kind == "uniform":
        return bits_to_uniform(bits)
    return (bits - ((bits >> 31) << 32)).to(torch.int32)  # uint32 bits as int32


def counter_rng_fill(n_chains: int, n_words: int, seed: int, step: int, tag: int,
                     kind: str = "bits", device=None, chain0: int = 0,
                     word0: int = 0) -> torch.Tensor:
    """``[n_chains, n_words]`` draws at ``(seed; chain0 + r, step, ·, tag)``
    for row ``r``, column ``j`` the sequence's word ``word0 + j``:
    ``kind="bits"`` the raw words (int32 holding uint32 bits; word ``w`` is
    word ``w % 4`` of group ``w // 4``), ``"uniform"`` their uniforms,
    ``"mh"`` the draws of :func:`mh_draws` for ``dim = n_words - 1`` (the
    normals, then the uniform in the last column; ``word0`` must be 0),
    ``"normal_pair"`` the normals of :func:`normals_paired`, column ``j``
    normal ``word0 + j`` (from an odd ``word0``, one launch of ``n_words +
    1`` columns from ``word0 − 1`` with its first column dropped).

    On a CUDA device this launches the fill kernel; on the CPU it computes
    the plain version.  Both raise on a fill the kernel does not take."""
    device = torch.device(device if device is not None else "cuda")
    if _odd_pair_start(kind, word0):
        return counter_rng_fill(n_chains, n_words + 1, seed, step, tag, kind, device, chain0,
                                word0 - 1)[:, 1:].contiguous()
    if device.type == "cpu":
        return counter_rng_fill_reference(n_chains, n_words, seed, step, tag, kind, device,
                                          chain0, word0)
    if device.type != "cuda":
        raise ValueError(f"counter_rng_fill runs on cuda or cpu, not {device}")
    from .._build import check

    global launches
    dtype = torch.int32 if kind == "bits" else torch.float32
    out = torch.empty((n_chains, n_words), dtype=dtype, device=device)
    lib, launch = fill_launcher(out, seed, step, tag, kind, chain0, word0)
    check(lib, launch(), "counter_rng_fill")
    launches += 1
    return out


def fill_launcher(out: torch.Tensor, seed: int, step: int, tag: int, kind: str,
                  chain0: int = 0, word0: int = 0):
    """``(lib, launch)``: ``launch()`` enqueues one fill of ``out``
    (``[n_chains, n_words]`` on the card, rows from ``chain0``, columns from
    ``word0``) and returns the CUDA error code, with no check and no count;
    :func:`counter_rng_fill` is the wrapper.  Exposed so that the kernel's
    device time can be taken over back-to-back launches."""
    from .._build import load

    _check_fill(out.shape[1], kind, chain0, word0)
    lib = load("counter_rng")
    fn = lib.counter_rng_fill
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (out.data_ptr(), out.shape[0], out.shape[1], seed & _MASK, step & _MASK,
            tag & _MASK, _KINDS[kind], chain0, word0,
            torch.cuda.current_stream(out.device).cuda_stream)
    return lib, lambda: fn(*args)


def pair_sweep(device=None, straight: bool = False):
    """The device function ``box_muller_pair`` (the fused HMC kernel's) or,
    with ``straight``, ``box_muller_pair_straight`` (the fused MH kernel's,
    free of branches) on every 24-bit uniform: word ``i << 8``, ``i < 2²⁴``,
    feeds the radius and the angle alike.  Returns ``(z_cos, z_sin, log_u,
    bits)``: the normals, the log of the uniform, and the words, whose plain
    :func:`box_muller_pair` and ``torch.log`` of :func:`bits_to_uniform`
    they are held against (card only)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError("pair_sweep runs the device function: give it a CUDA device")
    from .._build import check, load

    lib = load("counter_rng")
    fn = lib.counter_rng_pair_sweep
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 1 << 24
    z_cos = torch.empty(n, dtype=torch.float32, device=device)
    z_sin = torch.empty_like(z_cos)
    log_u = torch.empty_like(z_cos)
    code = fn(z_cos.data_ptr(), z_sin.data_ptr(), log_u.data_ptr(), n, int(straight),
              torch.cuda.current_stream(device).cuda_stream)
    check(lib, code, "counter_rng_pair_sweep")
    return z_cos, z_sin, log_u, torch.arange(n, dtype=torch.int64, device=device) << 8


def curand_check(keys: torch.Tensor, counters: torch.Tensor):
    """Philox4x32-10 of ``counters [n, 4]`` under ``keys [n, 2]`` (int32
    tensors of uint32 words on the card), from this package's device
    function and from the CUDA toolkit's ``curand_Philox4x32_10``: returns
    ``(mine, curand)``, each ``[n, 4]`` int32."""
    if keys.device.type != "cuda" or counters.device.type != "cuda":
        raise ValueError("curand_check compares two device functions: give it CUDA tensors")
    if keys.dtype != torch.int32 or counters.dtype != torch.int32:
        raise ValueError("keys and counters must be int32")
    n = counters.shape[0]
    if keys.shape != (n, 2) or counters.shape != (n, 4):
        raise ValueError("keys must be [n, 2] and counters [n, 4]")
    from .._build import check, load

    lib = load("counter_rng")
    fn = lib.counter_rng_curand_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys, counters = keys.contiguous(), counters.contiguous()
    mine = torch.empty_like(counters)
    theirs = torch.empty_like(counters)
    stream = torch.cuda.current_stream(counters.device).cuda_stream
    code = fn(keys.data_ptr(), counters.data_ptr(), mine.data_ptr(), theirs.data_ptr(), n,
              stream)
    check(lib, code, "counter_rng_curand_check")
    return mine, theirs
