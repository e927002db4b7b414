"""The port's counter-based generator (general_mcmc_torch/ops/counter_rng.py),
plain version: Philox4x32-10 known answers, the uniform map, batch
invariance and normal moments.  The device function's bits are held against
these on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from general_mcmc_torch.ops import counter_rng as cr
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

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
    full, u_full = cr.mh_draws(11, torch.arange(64), 5, 9)
    part, u_part = cr.mh_draws(11, torch.arange(40, 64), 5, 9)
    torch.testing.assert_close(part, full[40:], rtol=0, atol=0)
    torch.testing.assert_close(u_part, u_full[40:], rtol=0, atol=0)
    single, _ = cr.mh_draws(11, torch.tensor([17]), 5, 9)
    torch.testing.assert_close(single, full[17:18], rtol=0, atol=0)
    u_hmc = cr.uniforms(11, torch.arange(64), 5)
    torch.testing.assert_close(cr.uniforms(11, torch.arange(8, 16), 5), u_hmc[8:16],
                               rtol=0, atol=0)
    # and they differ across steps, tags and seeds
    assert not torch.equal(full, cr.mh_draws(11, torch.arange(64), 6, 9)[0])
    assert not torch.equal(full, cr.mh_draws(12, torch.arange(64), 5, 9)[0])
    assert not torch.equal(full, cr.mh_draws(11, torch.arange(64), 5, 9, tag=cr.TAG_ACCEPT)[0])


def test_normal_moments():
    """MH's normals and accept uniforms: 10⁵ normals (both Box–Muller
    branches) with normal moments, uniforms with the moments of U(0, 1), and
    no correlation between a step's uniform and its normals."""
    z, u = cr.mh_draws(3, torch.arange(2_000), 0, 50)
    z = z.double().ravel()
    assert z.numel() == 100_000
    assert abs(float(z.mean())) < 0.015
    assert abs(float(z.var()) - 1.0) < 0.02
    assert abs(float((z**3).mean())) < 0.05
    assert abs(float((z**4).mean()) - 3.0) < 0.1
    z2, u2 = cr.mh_draws(3, torch.arange(50_000), 7, 2)  # the main path's width
    u2 = u2.double()
    assert bool((u2 > 0).all()) and bool((u2 < 1).all())
    assert abs(float(u2.mean()) - 0.5) < 0.005
    assert abs(float(u2.var()) - 1.0 / 12.0) < 0.002
    for j in range(2):
        assert abs(float(torch.corrcoef(torch.stack([u2, z2[:, j].double()]))[0, 1])) < 0.015


def test_fill_reference_layouts():
    """The fill kernel's plain version: bits word j is word j % 4 of group
    j // 4; uniforms are those bits mapped; the mh kind is MH's normals and,
    in the last column, its accept uniform."""
    bits = cr.counter_rng_fill(5, 10, 9, 2, 0, "bits", device="cpu")
    assert bits.dtype == torch.int32 and bits.shape == (5, 10)
    w = cr.counter_bits(9, torch.arange(5)[:, None], 2, torch.arange(3)[None, :], 0)
    want = w.reshape(5, 12)[:, :10]
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want.numpy())
    uni = cr.counter_rng_fill(5, 10, 9, 2, 0, "uniform", device="cpu")
    torch.testing.assert_close(uni, cr.bits_to_uniform(want), rtol=0, atol=0)
    mh = cr.counter_rng_fill(5, 8, 9, 2, 0, "mh", device="cpu")
    z, u = cr.mh_draws(9, torch.arange(5), 2, 7, 0)
    assert mh.shape == (5, 8)
    torch.testing.assert_close(mh[:, :7], z, rtol=0, atol=0)
    torch.testing.assert_close(mh[:, 7], u, rtol=0, atol=0)
    z0 = cr.box_muller_pair(w[:, 0, 0], w[:, 0, 1])[0]
    torch.testing.assert_close(mh[:, 0], z0, rtol=0, atol=0)
    with pytest.raises(ValueError):
        cr.counter_rng_fill(5, 10, 9, 2, 0, "gamma", device="cpu")
    with pytest.raises(ValueError, match="mh layout"):
        cr.counter_rng_fill(5, 1, 9, 2, 0, "mh", device="cpu")


def test_tags_are_distinct_and_equal_the_header():
    """The Python tags and the kTag* constants of csrc/counter_rng.cuh are
    the same numbers (the header is read as text: nothing compiles here)."""
    import os
    import re

    tags = {"Momentum": cr.TAG_MOMENTUM, "Accept": cr.TAG_ACCEPT,
            "Proposal": cr.TAG_PROPOSAL, "Sign": cr.TAG_SIGN,
            "EpsSearch": cr.TAG_EPS_SEARCH, "Tree": cr.TAG_TREE,
            "EpsWindow": cr.TAG_EPS_WINDOW}
    assert len(set(tags.values())) == len(tags)
    header = os.path.join(os.path.dirname(cr.__file__), "..", "csrc", "counter_rng.cuh")
    with open(header) as f:
        found = dict(re.findall(r"constexpr uint32_t kTag(\w+) = (\d+)u;", f.read()))
    assert {k: int(v) for k, v in found.items()} == tags


def test_mh_draws_layout_and_batch_invariance():
    """MH's draws at dim 7: normals 2k, 2k + 1 are the cosine and sine
    branch of words (2k, 2k + 1) of (chain, step, ·, TAG_PROPOSAL), and the
    accept uniform is word 8 (group 2, word 0); the discrete walk's signs
    are the top bits of words 0..5 of its own tag and its uniform word 6;
    neither depends on the batch a chain is drawn in."""
    chains = torch.arange(32)
    z, u = cr.mh_draws(11, chains, 5, 7)
    assert z.dtype == u.dtype == torch.float32 and tuple(z.shape) == (32, 7)
    w = cr.counter_bits(11, chains[:, None], 5, torch.arange(3)[None, :],
                        cr.TAG_PROPOSAL).reshape(32, 12)
    for j in range(7):
        pair = cr.box_muller_pair(w[:, j - j % 2], w[:, j - j % 2 + 1])
        torch.testing.assert_close(z[:, j], pair[j % 2], rtol=0, atol=0)
    torch.testing.assert_close(u, cr.bits_to_uniform(w[:, 8]), rtol=0, atol=0)
    assert not torch.equal(z, cr.normals_paired(11, chains, 5, 7, cr.TAG_MOMENTUM))
    torch.testing.assert_close(z, cr.normals_paired(11, chains, 5, 7, cr.TAG_PROPOSAL),
                               rtol=0, atol=0)
    z_part, u_part = cr.mh_draws(11, chains[20:], 5, 7)
    torch.testing.assert_close(z_part, z[20:], rtol=0, atol=0)
    torch.testing.assert_close(u_part, u[20:], rtol=0, atol=0)
    s, u_sign = cr.sign_draws(11, chains, 5, 6)
    assert s.dtype == torch.bool and tuple(s.shape) == (32, 6)
    w = cr.counter_bits(11, chains[:, None], 5, torch.arange(2)[None, :], cr.TAG_SIGN)
    assert torch.equal(s, (w.reshape(32, 8)[:, :6] >> 31) == 1)
    torch.testing.assert_close(u_sign, cr.bits_to_uniform(w.reshape(32, 8)[:, 6]), rtol=0,
                               atol=0)
    assert torch.equal(cr.sign_draws(11, torch.tensor([9]), 5, 6)[0], s[9:10])
    assert not torch.equal(s, cr.sign_draws(11, chains, 6, 6)[0])
    flips = cr.sign_draws(3, torch.arange(5_000), 0, 4)[0].float().mean()
    assert abs(float(flips) - 0.5) < 0.02


def test_pair_cosine_is_box_muller_and_both_branches_are_normal():
    """box_muller_pair's first output is the JAX package's Box–Muller
    (_standard_normal: sqrt(-2 log u1)·cos(2π u2)), here in float64 from the
    same uniforms; both outputs have normal moments and are uncorrelated
    with each other."""
    w = cr.counter_bits(5, torch.arange(50_000)[:, None], 1, torch.arange(2)[None, :], 0)
    zc, zs = cr.box_muller_pair(w[..., 0], w[..., 1])
    u1 = cr.bits_to_uniform(w[..., 0]).double()
    u2 = cr.bits_to_uniform(w[..., 1]).double()
    want = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
    torch.testing.assert_close(zc.double(), want, rtol=1e-5, atol=2e-6)
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


def test_mh_layout_is_pinned():
    """One Philox block a step at dim 2: words 0 and 1 of (chain, step, 0,
    TAG_PROPOSAL) give both normals (cosine, then sine branch) and word 2
    the accept uniform; word 3 is unused.  Golden values: the words are
    Random123's Philox of that counter, the draws a pure function of them."""
    w0 = cr.counter_bits(0, torch.tensor([0]), 0, 0, cr.TAG_PROPOSAL)[0]
    assert [int(v) for v in w0] == _philox_py([0, 0, 0, cr.TAG_PROPOSAL], [0, 0])
    assert [int(v) for v in w0] == [3710895380, 2918555867, 3874949922, 3551840884]
    chains = torch.tensor([3, 4])
    w = cr.counter_bits(7, chains, 11, 0, cr.TAG_PROPOSAL)
    assert [int(v) for v in w[0]] == [1713569341, 925050125, 2081745248, 294536452]
    z, u = cr.mh_draws(7, chains, 11, 2)
    zc, zs = cr.box_muller_pair(w[:, 0], w[:, 1])
    torch.testing.assert_close(z, torch.stack([zc, zs], dim=1), rtol=0, atol=0)
    torch.testing.assert_close(u, cr.bits_to_uniform(w[:, 2]), rtol=0, atol=0)
    assert float(u[0]) == (2081745248 >> 8) * 2.0**-24 + 2.0**-25
    torch.testing.assert_close(z, torch.tensor([[0.2925613224506378, 1.323683738708496],
                                                [-0.15453889966011047, 2.132591485977173]]),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(u, torch.tensor([0.48469409346580505, 0.7070674896240234]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dim,blocks,u_word", [(1, 1, 2), (2, 1, 2), (3, 2, 4), (4, 2, 4),
                                               (5, 2, 6), (8, 3, 8), (100, 26, 100)])
def test_mh_draws_read_words_in_sequence(dim, blocks, u_word):
    """The normals take words 0 .. 2⌈dim/2⌉ − 1 and the uniform the next:
    ⌈dim/2⌉ // 2 + 1 blocks a step (26 at dim 100, where the cosine-only
    layout took 51)."""
    chains = torch.arange(9)
    z, u = cr.mh_draws(4, chains, 2, dim)
    w = cr.counter_bits(4, chains[:, None], 2, torch.arange(blocks)[None, :],
                        cr.TAG_PROPOSAL).reshape(9, -1)
    assert u_word == 2 * ((dim + 1) // 2) and u_word // 4 == blocks - 1
    torch.testing.assert_close(u, cr.bits_to_uniform(w[:, u_word]), rtol=0, atol=0)
    torch.testing.assert_close(z, cr.normals_paired(4, chains, 2, dim, cr.TAG_PROPOSAL),
                               rtol=0, atol=0)
    fill = cr.counter_rng_fill(9, dim + 1, 4, 2, cr.TAG_PROPOSAL, "mh", device="cpu")
    torch.testing.assert_close(fill, torch.cat([z, u[:, None]], dim=1), rtol=0, atol=0)


def test_hmc_stream_is_unchanged():
    """HMC's momenta (normals_paired under TAG_MOMENTUM) and accept uniforms
    (word 0 of TAG_ACCEPT) keep the bits they had before MH's draws moved
    to one word sequence: golden values taken from the earlier layout's
    code, and a short HMC run's last states."""
    import general_mcmc_torch as g

    w = cr.counter_bits(9, torch.tensor([2]), 4, 1, cr.TAG_MOMENTUM)[0]
    assert [int(v) for v in w] == [518581120, 1988283848, 3896622713, 1622034016]
    w = cr.counter_bits(9, torch.tensor([2]), 4, 0, cr.TAG_ACCEPT)[0]
    assert [int(v) for v in w] == [4242091672, 2828561485, 2229461248, 1779617763]
    z = cr.normals_paired(9, torch.arange(3), 4, 6)
    torch.testing.assert_close(z, torch.tensor([
        [-0.8415234088897705, 0.721241295337677, 0.37681642174720764, -2.737266778945923,
         -0.30938291549682617, 0.5619316101074219],
        [0.19841720163822174, 0.2441571056842804, 1.1413366794586182, 0.27567529678344727,
         -1.9063184261322021, -0.3050258457660675],
        [-0.15591362118721008, -1.2832353115081787, 0.4174768030643463, 1.6132025718688965,
         -2.0007452964782715, 0.4745776951313019]]), rtol=1e-6, atol=1e-7)
    u = cr.uniforms(9, torch.arange(3), 4)
    torch.testing.assert_close(u, torch.tensor(
        [0.499582439661026, 0.451772004365921, 0.9876888990402222]), rtol=0, atol=0)
    t = g.GaussianND(torch.zeros(5), torch.linspace(0.5, 2, 5), device="cpu")
    x0 = g.init_with_seed(4, 5, 1, device="cpu")
    s = g.HMC(t, x0, 0.3, 5, seed=3, device="cpu").run(3, 2)
    torch.testing.assert_close(s[:, -1], torch.tensor([
        [1.5064932107925415, 0.22221246361732483, -1.0089008808135986, 0.8674811124801636,
         0.6818387508392334],
        [-0.2708233892917633, 0.0021851733326911926, 0.28393906354904175, -1.0263843536376953,
         -1.2084243297576904],
        [-1.6957170963287354, -0.5943855047225952, 1.210091471672058, -2.399041175842285,
         -0.2352045178413391],
        [0.34427008032798767, 0.38208070397377014, 0.37375807762145996, 1.2181580066680908,
         -0.5526200532913208]]), rtol=1e-5, atol=1e-6)


def test_static_draws_layout():
    """The static tree's draws: the momenta are HMC's pairs under
    TAG_MOMENTUM; the rest are 2 + 2J raw words of one word sequence under
    TAG_STATIC, a tag of its own, word j word j % 4 of the block at group
    j // 4, as uint32 bits in int32; words_to_uniform is the uniform map of
    those bits."""
    n, d, depth, seed, step = 6, 5, 4, 13, 9
    z, w = cr.static_draws(seed, n, step, d, depth, "cpu")
    chains = torch.arange(n)
    assert torch.equal(z, cr.normals_paired(seed, chains, step, d))
    assert cr.static_words(depth) == 2 + 2 * depth
    assert w.dtype == torch.int32 and tuple(w.shape) == (n, cr.static_words(depth))
    tags = [cr.TAG_MOMENTUM, cr.TAG_ACCEPT, cr.TAG_PROPOSAL, cr.TAG_SIGN, cr.TAG_EPS_SEARCH,
            cr.TAG_TREE, cr.TAG_EPS_WINDOW]
    assert cr.TAG_STATIC == 7 and cr.TAG_STATIC not in tags
    for j in range(cr.static_words(depth)):
        word = cr.counter_bits(seed, chains, step, j // 4, cr.TAG_STATIC)[:, j % 4]
        assert torch.equal(w[:, j].long() & _MASK, word)
        assert torch.equal(cr.words_to_uniform(w[:, j]), cr.bits_to_uniform(word))
    assert torch.equal(w, cr.counter_rng_fill_reference(n, 2 + 2 * depth, seed, step,
                                                        cr.TAG_STATIC, "bits"))


@pytest.mark.parametrize("kind,word0", [("bits", 0), ("bits", 3), ("bits", 6),
                                        ("uniform", 1), ("uniform", 8),
                                        ("normal_pair", 2), ("normal_pair", 4),
                                        ("normal_pair", 10), ("mh", 0)])
@pytest.mark.parametrize("n_words", [1, 5, 8])
def test_fill_offsets_are_rows_and_columns_of_the_unshifted_fill(kind, word0, n_words):
    """A fill of rows from chain0 and columns from word0 is that block of the
    fill from (0, 0), bit for bit: what a rank holding a block of chains and
    coordinates draws."""
    if kind == "mh" and n_words < 2:
        n_words = 2
    whole = cr.counter_rng_fill(13, word0 + n_words, 9, 2, cr.TAG_MOMENTUM, kind, "cpu")
    block = cr.counter_rng_fill(4, n_words, 9, 2, cr.TAG_MOMENTUM, kind, "cpu", chain0=7,
                                word0=word0)
    assert block.shape == (4, n_words) and block.dtype == whole.dtype
    assert torch.equal(block, whole[7:11, word0:])
    assert torch.equal(cr.counter_rng_fill_reference(4, n_words, 9, 2, cr.TAG_MOMENTUM, kind,
                                                     chain0=7, word0=word0), block)


def test_draw_helpers_take_the_block_offsets():
    """The samplers' draw helpers: momentum normals from (chain0, word0),
    the per-chain uniforms and tree words from chain0 alone."""
    z, u = cr.nuts_draws(5, 12, 3, 8, 3, "cpu")
    zb, ub = cr.nuts_draws(5, 4, 3, 4, 3, "cpu", chain0=8, word0=4)
    assert torch.equal(zb, z[8:12, 4:8]) and torch.equal(ub, u[8:12])
    z, u = cr.step_draws(5, 12, 3, 6, "cpu")
    zb, ub = cr.step_draws(5, 6, 3, 2, "cpu", chain0=6, word0=4)
    assert torch.equal(zb, z[6:12, 4:6]) and torch.equal(ub, u[6:12])
    for fn, args in ((cr.walk_draws, (5, 12, 3, 3)), (cr.sign_walk_draws, (5, 12, 3, 3)),
                     (cr.gibbs_draws, (5, 12, 3, 3)), (cr.tempering_draws, (5, 12, 3, 4, 2))):
        whole = fn(*args, device="cpu")
        block = fn(args[0], 5, *args[2:], device="cpu", chain0=7)
        for w, b in zip(whole, block):
            assert torch.equal(b, w[7:12])
    assert torch.equal(cr.static_draws(5, 4, 3, 4, 2, "cpu", chain0=2)[1],
                       cr.static_draws(5, 6, 3, 4, 2, "cpu")[1][2:])


@pytest.mark.parametrize("kind,chain0,word0,match", [
    ("normal_pair", 0, 3, "even word"),
    ("mh", 0, 2, "word0 must be 0"),
    ("bits", -1, 0, "uint32"),
    ("bits", 0, 2**32, "uint32"),
])
def test_fill_offset_errors(kind, chain0, word0, match):
    """The fill kernel's launcher refuses every one of these.  The wrapper
    and its plain version refuse them too, but normal pairs from an odd
    word: those they fill from the even word before, one column wider, and
    drop that column (what a dim block at an odd coordinate draws)."""
    if kind == "normal_pair":
        got = cr.counter_rng_fill(4, 6, 9, 2, 0, kind, "cpu", chain0=chain0, word0=word0)
        whole = cr.counter_rng_fill(4, 6 + word0, 9, 2, 0, kind, "cpu", chain0=chain0)
        assert torch.equal(got, whole[:, word0:])
    else:
        with pytest.raises(ValueError, match=match):
            cr.counter_rng_fill(4, 6, 9, 2, 0, kind, "cpu", chain0=chain0, word0=word0)
    with pytest.raises(ValueError, match=match):
        cr.fill_launcher(torch.empty(4, 6), 9, 2, 0, kind, chain0, word0)


@pytest.mark.parametrize("col0,d", [(1, 1), (1, 4), (3, 3), (25, 25), (75, 25), (9, 3)])
def test_odd_column_block_draws_are_columns_of_the_unshifted_draws(col0, d):
    """A dim block that starts at an odd coordinate: its momentum normals
    (``step_draws``, ``nuts_draws``, the step-size searches' fills) are
    columns ``[col0, col0 + d)`` of the unshifted draws, bit for bit, from
    the wrapper and from the plain version alike, and a contiguous
    ``[n, d]`` tensor."""
    n = 6
    whole = cr.counter_rng_fill(n + 3, col0 + d, 5, 4, cr.TAG_MOMENTUM, "normal_pair", "cpu")
    for fill in (cr.counter_rng_fill, cr.counter_rng_fill_reference):
        block = fill(n, d, 5, 4, cr.TAG_MOMENTUM, "normal_pair", "cpu", chain0=3, word0=col0)
        assert block.shape == (n, d) and block.is_contiguous()
        assert torch.equal(block, whole[3:, col0:])
    z, u = cr.step_draws(5, n, 4, d, "cpu", chain0=3, word0=col0)
    assert torch.equal(z, whole[3:, col0:])
    assert torch.equal(u, cr.step_draws(5, n + 3, 4, 1, "cpu")[1][3:])
    zn, un = cr.nuts_draws(5, n, 4, d, 3, "cpu", chain0=3, word0=col0)
    assert torch.equal(zn, whole[3:, col0:])
    assert torch.equal(un, cr.nuts_draws(5, n + 3, 4, 2, 3, "cpu")[1][3:])
