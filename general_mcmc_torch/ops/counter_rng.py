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
and the Box–Muller cosine branch are the JAX package's; the fused HMC kernel
also takes the sine branch of the same two uniforms, an independent normal,
so that one Philox block serves four dimensions (:func:`box_muller_pair`).

The plain version holds uint32 words in int64 tensors.  A 32×32-bit product
can reach 2⁶⁴ and overflow int64, so the multiplier is split into 16-bit
halves and each partial product stays below 2⁴⁸.

Which words each sampler reads at (seed; chain, step):

- HMC: momentum normals ``4q`` and ``4q + 1`` are the cosine and the sine
  branch of Box–Muller of words ``(0, 1)``, and normals ``4q + 2`` and
  ``4q + 3`` those of words ``(2, 3)``, of the counter (chain, step, group
  ``q``, ``TAG_MOMENTUM``) (:func:`normals_paired`); the accept uniform is
  word 0 of (chain, step, group 0, ``TAG_ACCEPT``) (:func:`uniforms`).
- MH: proposal normal ``j`` is the cosine branch of words ``(2e, 2e + 1)``,
  ``e = j % 2``, of (chain, step, group ``j // 2``, ``TAG_PROPOSAL``)
  (:func:`normals`); the discrete walk's sign for coordinate ``j`` is the
  top bit of word ``j % 4`` of (chain, step, group ``j // 4``, ``TAG_SIGN``)
  (:func:`signs`); the accept uniform is the same word as HMC's.

The tags are the same numbers as ``kTag*`` in ``csrc/counter_rng.cuh``.

``counter_rng_fill`` launches the fill kernel of ``csrc/counter_rng.cu``,
which writes the device function's draws to a tensor; it exists to hold
the device function against the plain version and is not on the sampling
path (the generator runs inside the fused HMC and MH kernels there).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "TAG_MOMENTUM",
    "TAG_ACCEPT",
    "TAG_PROPOSAL",
    "TAG_SIGN",
    "philox4x32_10",
    "counter_bits",
    "bits_to_uniform",
    "box_muller",
    "box_muller_pair",
    "normals",
    "normals_paired",
    "uniforms",
    "signs",
    "counter_rng_fill",
    "counter_rng_fill_reference",
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

# Launches of the fill kernel (counter_rng_fill) in this process.
launches = 0

_KINDS = {"bits": 0, "uniform": 1, "normal": 2, "normal_pair": 3}


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


def box_muller(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """One normal from two words, cosine branch (JAX ``_standard_normal``)."""
    u1 = bits_to_uniform(b1)
    u2 = bits_to_uniform(b2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def box_muller_pair(b1: torch.Tensor, b2: torch.Tensor):
    """Two independent normals from two words: the cosine branch (which is
    :func:`box_muller`) and the sine branch of the same radius and angle."""
    u1 = bits_to_uniform(b1)
    u2 = bits_to_uniform(b2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = _TWO_PI * u2
    return r * torch.cos(angle), r * torch.sin(angle)


def normals(seed: int, chains: torch.Tensor, step: int, dim: int,
            tag: int = TAG_MOMENTUM) -> torch.Tensor:
    """``[n_chains, dim]`` float32 standard normals: normal ``j`` of a chain
    is the cosine branch of Box–Muller of words ``(2e, 2e+1)``,
    ``e = j % 2``, of group ``j // 2`` — the fused MH kernel's proposal
    layout."""
    groups = torch.arange((dim + 1) // 2, dtype=torch.int64, device=chains.device)
    w = counter_bits(seed, chains[:, None], step, groups[None, :], tag)
    z = torch.stack([box_muller(w[..., 0], w[..., 1]), box_muller(w[..., 2], w[..., 3])],
                    dim=-1)
    return z.reshape(chains.shape[0], -1)[:, :dim]


def normals_paired(seed: int, chains: torch.Tensor, step: int, dim: int,
                   tag: int = TAG_MOMENTUM) -> torch.Tensor:
    """``[n_chains, dim]`` float32 standard normals, four from each Philox
    block: normals ``4q`` and ``4q + 1`` of a chain are the cosine and sine
    branch of words ``(0, 1)`` of group ``q``, normals ``4q + 2`` and
    ``4q + 3`` those of words ``(2, 3)`` — the fused HMC kernel's momentum
    layout."""
    groups = torch.arange((dim + 3) // 4, dtype=torch.int64, device=chains.device)
    w = counter_bits(seed, chains[:, None], step, groups[None, :], tag)
    z = torch.stack([*box_muller_pair(w[..., 0], w[..., 1]),
                     *box_muller_pair(w[..., 2], w[..., 3])], dim=-1)
    return z.reshape(chains.shape[0], -1)[:, :dim]


def uniforms(seed: int, chains: torch.Tensor, step: int,
             tag: int = TAG_ACCEPT) -> torch.Tensor:
    """``[n_chains]`` float32 uniforms: word 0 of group 0."""
    w = counter_bits(seed, chains, step, 0, tag)
    return bits_to_uniform(w[..., 0])


def signs(seed: int, chains: torch.Tensor, step: int, dim: int,
          tag: int = TAG_SIGN) -> torch.Tensor:
    """``[n_chains, dim]`` fair coin flips (bool): flip ``j`` is the top bit
    of word ``j % 4`` of group ``j // 4``."""
    groups = torch.arange((dim + 3) // 4, dtype=torch.int64, device=chains.device)
    w = counter_bits(seed, chains[:, None], step, groups[None, :], tag)
    return (w.reshape(chains.shape[0], -1)[:, :dim] >> 31) == 1


def counter_rng_fill_reference(n_chains: int, n_words: int, seed: int, step: int,
                               tag: int, kind: str = "bits",
                               device=None) -> torch.Tensor:
    """Plain version of :func:`counter_rng_fill`."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)
    if kind == "normal":
        return normals(seed, chains, step, n_words, tag)
    if kind == "normal_pair":
        return normals_paired(seed, chains, step, n_words, tag)
    groups = torch.arange((n_words + 3) // 4, dtype=torch.int64, device=device)
    w = counter_bits(seed, chains[:, None], step, groups[None, :], tag)
    bits = w.reshape(n_chains, -1)[:, :n_words]
    if kind == "uniform":
        return bits_to_uniform(bits)
    return (bits - ((bits >> 31) << 32)).to(torch.int32)  # uint32 bits as int32


def counter_rng_fill(n_chains: int, n_words: int, seed: int, step: int, tag: int,
                     kind: str = "bits", device=None) -> torch.Tensor:
    """``[n_chains, n_words]`` draws at ``(seed; chain, step, ·, tag)``:
    ``kind="bits"`` the raw words (int32 holding uint32 bits; word ``j`` is
    word ``j % 4`` of group ``j // 4``), ``"uniform"`` their uniforms,
    ``"normal"`` the normals of :func:`normals`, ``"normal_pair"`` those of
    :func:`normals_paired`.

    On a CUDA device this launches the fill kernel; on the CPU it computes
    the plain version."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cpu":
        return counter_rng_fill_reference(n_chains, n_words, seed, step, tag, kind, device)
    if device.type != "cuda":
        raise ValueError(f"counter_rng_fill runs on cuda or cpu, not {device}")
    from .._build import check, load

    global launches
    lib = load("counter_rng")
    fn = lib.counter_rng_fill
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dtype = torch.int32 if kind == "bits" else torch.float32
    out = torch.empty((n_chains, n_words), dtype=dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(out.data_ptr(), n_chains, n_words, seed & _MASK, step & _MASK, tag & _MASK,
              _KINDS[kind], stream)
    check(lib, code, "counter_rng_fill")
    launches += 1
    return out


def pair_sweep(device=None):
    """The device function ``box_muller_pair`` on every 24-bit uniform: word
    ``i << 8``, ``i < 2²⁴``, feeds the radius and the angle alike.  Returns
    ``(z_cos, z_sin, bits)``; the plain :func:`box_muller_pair` of ``bits``
    is what they are held against (card only)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError("pair_sweep runs the device function: give it a CUDA device")
    from .._build import check, load

    lib = load("counter_rng")
    fn = lib.counter_rng_pair_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 1 << 24
    z_cos = torch.empty(n, dtype=torch.float32, device=device)
    z_sin = torch.empty_like(z_cos)
    code = fn(z_cos.data_ptr(), z_sin.data_ptr(), n,
              torch.cuda.current_stream(device).cuda_stream)
    check(lib, code, "counter_rng_pair_sweep")
    return z_cos, z_sin, torch.arange(n, dtype=torch.int64, device=device) << 8


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
