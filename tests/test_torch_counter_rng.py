"""The port's counter-based generator (general_mcmc_torch/ops/counter_rng.py),
plain version: Philox4x32-10 known answers, the uniform map, batch
invariance and normal moments.  The device function's bits are held against
these on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from general_mcmc_torch.ops import counter_rng as cr

_MASK = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Random123 Philox4x32-10 in Python integers."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & _MASK, (k[1] + 0xBB67AE85) & _MASK]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _MASK, (p0 >> 32) ^ c[3] ^ k[1], p0 & _MASK]
    return c


# Random123's published known-answer vectors for philox4x32_10; chip_smoke.py
# checks the device function against curand's Philox on the same inputs.
_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_MASK,) * 4, (_MASK, _MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _KAT)
def test_philox_known_answers(ctr, key, want):
    got = cr.philox4x32_10(*ctr, key[0], key[1])
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_py(ctr, key)) == want


def test_philox_matches_python_on_random_inputs():
    """The 16-bit split multiply never overflows int64: every word agrees
    with the Python-integer Philox over random full-range counters."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(257, 4), dtype=np.uint64).astype(np.int64)
    key = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.int64)
    got = torch.stack(
        cr.philox4x32_10(*(torch.from_numpy(ctr[:, i]) for i in range(4)),
                         int(key[0]), int(key[1])), dim=-1)
    want = [_philox_py([int(v) for v in row], [int(key[0]), int(key[1])]) for row in ctr]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.int64))


def test_uniform_range_and_map():
    """(bits >> 8)·2⁻²⁴ + 2⁻²⁵ in float32: never 0; below 1 for every word
    but the top 24-bit value, which rounds to 1.0 in float32 exactly as the
    JAX package's _uniform_01 does."""
    edge = torch.tensor([0, 255, 256, 0xFFFFFEFF, 0xFFFFFFFF], dtype=torch.int64)
    u = cr.bits_to_uniform(edge)
    assert u.dtype == torch.float32
    assert float(u[0]) == 2.0**-25 and float(u[1]) == 2.0**-25
    assert float(u[2]) == 2.0**-24 + 2.0**-25
    assert float(u[3]) < 1.0 and float(u[4]) == 1.0
    draws = cr.uniforms(7, torch.arange(50_000), 3)
    assert bool((draws > 0).all()) and bool((draws < 1).all())
    assert abs(float(draws.mean()) - 0.5) < 0.01


def test_draws_invariant_to_chain_batch():
    """A chain's draws depend on its global index and the step only, not on
    the batch it is computed in."""
    full = cr.normals(11, torch.arange(64), 5, 9)
    part = cr.normals(11, torch.arange(40, 64), 5, 9)
    torch.testing.assert_close(part, full[40:], rtol=0, atol=0)
    single = cr.normals(11, torch.tensor([17]), 5, 9)
    torch.testing.assert_close(single, full[17:18], rtol=0, atol=0)
    u_full = cr.uniforms(11, torch.arange(64), 5)
    torch.testing.assert_close(cr.uniforms(11, torch.arange(8, 16), 5), u_full[8:16],
                               rtol=0, atol=0)
    # and they differ across steps, tags and seeds
    assert not torch.equal(full, cr.normals(11, torch.arange(64), 6, 9))
    assert not torch.equal(full, cr.normals(12, torch.arange(64), 5, 9))
    assert not torch.equal(full, cr.normals(11, torch.arange(64), 5, 9, tag=cr.TAG_ACCEPT))


def test_normal_moments():
    z = cr.normals(3, torch.arange(2_000), 0, 50).double().ravel()  # 10^5 draws
    assert z.numel() == 100_000
    assert abs(float(z.mean())) < 0.015
    assert abs(float(z.var()) - 1.0) < 0.02
    assert abs(float((z**3).mean())) < 0.05
    assert abs(float((z**4).mean()) - 3.0) < 0.1


def test_fill_reference_layouts():
    """The fill kernel's plain version: bits word j is word j % 4 of group
    j // 4; uniforms are those bits mapped; normals are the momentum
    layout."""
    bits = cr.counter_rng_fill(5, 10, 9, 2, 0, "bits", device="cpu")
    assert bits.dtype == torch.int32 and bits.shape == (5, 10)
    w = cr.counter_bits(9, torch.arange(5)[:, None], 2, torch.arange(3)[None, :], 0)
    want = w.reshape(5, 12)[:, :10]
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want.numpy())
    uni = cr.counter_rng_fill(5, 10, 9, 2, 0, "uniform", device="cpu")
    torch.testing.assert_close(uni, cr.bits_to_uniform(want), rtol=0, atol=0)
    nrm = cr.counter_rng_fill(5, 7, 9, 2, 0, "normal", device="cpu")
    torch.testing.assert_close(nrm, cr.normals(9, torch.arange(5), 2, 7), rtol=0, atol=0)
    z0 = cr.box_muller(w[:, 0, 0], w[:, 0, 1])
    torch.testing.assert_close(nrm[:, 0], z0, rtol=0, atol=0)
    with pytest.raises(ValueError):
        cr.counter_rng_fill(5, 10, 9, 2, 0, "gamma", device="cpu")


def test_tags_are_distinct_and_equal_the_header():
    """The Python tags and the kTag* constants of csrc/counter_rng.cuh are
    the same numbers (the header is read as text: nothing compiles here)."""
    import os
    import re

    tags = {"Momentum": cr.TAG_MOMENTUM, "Accept": cr.TAG_ACCEPT,
            "Proposal": cr.TAG_PROPOSAL, "Sign": cr.TAG_SIGN}
    assert len(set(tags.values())) == len(tags)
    header = os.path.join(os.path.dirname(cr.__file__), "..", "csrc", "counter_rng.cuh")
    with open(header) as f:
        found = dict(re.findall(r"constexpr uint32_t kTag(\w+) = (\d+)u;", f.read()))
    assert {k: int(v) for k, v in found.items()} == tags


def test_mh_draws_layout_and_batch_invariance():
    """MH's proposal normals have the momentum layout under their own tag;
    the discrete walk's signs are the top bits of the sign-tag words; neither
    depends on the batch a chain is drawn in."""
    chains = torch.arange(32)
    z = cr.normals(11, chains, 5, 7, cr.TAG_PROPOSAL)
    assert not torch.equal(z, cr.normals(11, chains, 5, 7, cr.TAG_MOMENTUM))
    torch.testing.assert_close(cr.normals(11, chains[20:], 5, 7, cr.TAG_PROPOSAL), z[20:],
                               rtol=0, atol=0)
    s = cr.signs(11, chains, 5, 6)
    assert s.dtype == torch.bool and tuple(s.shape) == (32, 6)
    w = cr.counter_bits(11, chains[:, None], 5, torch.arange(2)[None, :], cr.TAG_SIGN)
    assert torch.equal(s, (w.reshape(32, 8)[:, :6] >> 31) == 1)
    assert torch.equal(cr.signs(11, torch.tensor([9]), 5, 6), s[9:10])
    assert not torch.equal(s, cr.signs(11, chains, 6, 6))
    flips = cr.signs(3, torch.arange(5_000), 0, 4).float().mean()
    assert abs(float(flips) - 0.5) < 0.02


def test_pair_cosine_is_box_muller_and_both_branches_are_normal():
    """box_muller_pair's first output is box_muller of the same words; both
    outputs have normal moments and are uncorrelated with each other."""
    w = cr.counter_bits(5, torch.arange(50_000)[:, None], 1, torch.arange(2)[None, :], 0)
    zc, zs = cr.box_muller_pair(w[..., 0], w[..., 1])
    torch.testing.assert_close(zc, cr.box_muller(w[..., 0], w[..., 1]), rtol=0, atol=0)
    zc, zs = zc.double().ravel(), zs.double().ravel()  # 10^5 draws each
    for z in (zc, zs):
        assert abs(float(z.mean())) < 0.015
        assert abs(float(z.var()) - 1.0) < 0.02
        assert abs(float((z**3).mean())) < 0.05
        assert abs(float((z**4).mean()) - 3.0) < 0.1
    assert abs(float((zc * zs).mean())) < 0.015
    assert abs(float((zc**2 * zs**2).mean()) - 1.0) < 0.05  # independent, not only uncorrelated
    # the same radius: zc^2 + zs^2 = -2 log u1
    r2 = -2.0 * torch.log(cr.bits_to_uniform(w[..., 0])).double().ravel()
    torch.testing.assert_close(zc**2 + zs**2, r2, rtol=1e-5, atol=1e-6)


def test_paired_layout_is_pinned():
    """Which block and words feed momentum j, and which word the accept
    uniform: normals 4q, 4q+1 are the cosine and sine branch of words (0, 1)
    of (chain, step, group q, TAG_MOMENTUM), normals 4q+2, 4q+3 those of
    words (2, 3); the accept uniform is word 0 of (chain, step, 0,
    TAG_ACCEPT)."""
    chains = torch.arange(6)
    z = cr.normals_paired(9, chains, 4, 11)
    assert z.dtype == torch.float32 and tuple(z.shape) == (6, 11)
    for j in range(11):
        w = cr.counter_bits(9, chains, 4, j // 4, cr.TAG_MOMENTUM)
        pair = cr.box_muller_pair(w[:, 2 * ((j % 4) // 2)], w[:, 2 * ((j % 4) // 2) + 1])
        torch.testing.assert_close(z[:, j], pair[j % 2], rtol=0, atol=0)
    u = cr.uniforms(9, chains, 4)
    w = cr.counter_bits(9, chains, 4, 0, cr.TAG_ACCEPT)
    torch.testing.assert_close(u, cr.bits_to_uniform(w[:, 0]), rtol=0, atol=0)
    # a golden value: the draws are a pure function of (seed; chain, step, j)
    w0 = cr.counter_bits(0, torch.tensor([0]), 0, 0, cr.TAG_MOMENTUM)[0]
    assert [int(v) for v in w0] == _philox_py([0, 0, 0, cr.TAG_MOMENTUM], [0, 0])
    # the fill kernel's plain version has the same layout under its kind
    fill = cr.counter_rng_fill(6, 11, 9, 4, cr.TAG_MOMENTUM, "normal_pair", device="cpu")
    torch.testing.assert_close(fill, z, rtol=0, atol=0)


@pytest.mark.parametrize("dim,lanes,quads", [(100, 16, 2), (100, 8, 4), (33, 4, 3), (7, 1, 2),
                                             (512, 32, 4)])
def test_paired_draws_invariant_to_chain_batch_and_lane_map(dim, lanes, quads):
    """A chain's momenta depend on (seed; chain, step, dimension) only: not
    on the batch, and not on the fused kernel's lane map.  The map gives lane
    ``sub`` of a chain's group the quads ``sub + lanes·k``; assembling the
    draws lane by lane as the kernel does gives normals_paired whatever the
    map, and the first idle lane slot is where the accept block is drawn."""
    full = cr.normals_paired(11, torch.arange(40), 5, dim)
    torch.testing.assert_close(cr.normals_paired(11, torch.arange(25, 40), 5, dim), full[25:],
                               rtol=0, atol=0)
    assert not torch.equal(full, cr.normals_paired(11, torch.arange(40), 6, dim))
    chains = torch.arange(25, 40)
    n_quads = (dim + 3) // 4
    assert lanes * quads >= n_quads
    by_lane = torch.zeros(15, 4 * lanes * quads)
    for sub in range(lanes):
        for k in range(quads):
            q = sub + lanes * k
            w = cr.counter_bits(11, chains, 5, q, cr.TAG_MOMENTUM)
            zc0, zs0 = cr.box_muller_pair(w[:, 0], w[:, 1])
            zc1, zs1 = cr.box_muller_pair(w[:, 2], w[:, 3])
            by_lane[:, 4 * q:4 * q + 4] = torch.stack([zc0, zs0, zc1, zs1], dim=1)
    torch.testing.assert_close(by_lane[:, :dim], full[25:], rtol=0, atol=0)
