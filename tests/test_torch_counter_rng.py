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
