"""Dropout bits of the PyTorch port (ops/kernel_prng.py, the plain version of
csrc/kernel_prng.cuh): Philox-4x32-10 of global coordinates, one call per 8
columns, 16 bits an element.

Also documents why the JAX package's interpret-mode hash
(orbit2_tpu/ops/kernel_prng.py:33-38) is not the port's generator: it XORs
the block seed into a local index, so two blocks whose seeds differ by a
small step get masks that are XOR-permutations of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.ops import kernel_prng as jax_prng
from orbit2_tpu_torch.ops.kernel_prng import (
    draw_seed,
    dropout_bits,
    keep_mult,
    keep_threshold,
    philox4x32_10,
)

SEED = 0x0123456789ABCDEF


def bits(seed, stream, rows, cols):
    """Bits of the stream's [rows] x [cols] index ranges, as int64 [R, C]."""
    return dropout_bits(seed, torch.tensor(stream), torch.as_tensor(rows).view(-1, 1),
                        torch.as_tensor(cols).view(1, -1))


def test_philox_known_answers():
    """Random123's published philox4x32_10 test vectors."""
    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, (k0, k1), want in vectors:
        got = philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), k0 | k1 << 32)
        assert [int(w) for w in got] == list(want)


def test_bits_are_deterministic_and_independent_of_tiling():
    whole = bits(SEED, 3, range(40), range(70))
    assert torch.equal(whole, bits(SEED, 3, range(40), range(70)))
    assert bool((whole >= 0).all() and (whole < 2 ** 16).all())
    # any tiling, including tiles that start off an 8-column boundary
    for r0, r1 in ((0, 13), (13, 29), (29, 40)):
        for c0, c1 in ((0, 7), (7, 33), (33, 70)):
            assert torch.equal(bits(SEED, 3, range(r0, r1), range(c0, c1)), whole[r0:r1, c0:c1])
    # every coordinate and the seed change the bits
    assert not torch.equal(whole, bits(SEED, 4, range(40), range(70)))
    assert not torch.equal(whole, bits(SEED + 1, 3, range(40), range(70)))
    assert not torch.equal(whole[:, :64], bits(SEED, 3, range(40), range(64, 128)))
    assert not torch.equal(whole[:32], bits(SEED, 3, range(32, 64), range(70)))


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_keep_fraction_and_values(rate):
    mult = keep_mult(SEED, 512, 1024, rate)
    keep = 1.0 - rate
    assert set(torch.unique(mult).tolist()) == {0.0, float(np.float32(1.0 / keep))}
    n = mult.numel()
    frac = (mult > 0).double().mean().item()
    assert abs(frac - keep) < 4 * (keep * (1 - keep) / n) ** 0.5
    assert keep_threshold(rate) == int(keep * 65535.0)


@pytest.mark.parametrize("col", range(16))
def test_sixteen_bit_lanes_of_one_call(col):
    """Element (row, col) is the 16-bit half col % 2 of word (col % 8) // 2 of
    one Philox call of counter (col // 8, row, stream, 0): every position of
    two calls, against a direct philox4x32_10 call."""
    seed, stream, row = 0xFEDCBA9876543210, 11, 1234
    words = philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                            for c in (col // 8, row, stream, 0)), seed)
    want = (int(words[(col % 8) // 2]) >> (16 * (col % 2))) & 0xFFFF
    assert int(bits(seed, stream, [row], [col])[0, 0]) == want
    # the row of keep_mult's bulk path agrees with the element-wise one
    assert int(bits(seed, 0, [row], range(col + 1))[0, col]) == int(bits(seed, 0, [row], [col])[0, 0])


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_keep_probability_is_within_two_to_the_minus_16(rate):
    """P(keep) = (t16 + 1) / 2^16 for uniform 16-bit halves."""
    t16 = keep_threshold(rate)
    assert 0 <= t16 < 2 ** 16 - 1
    assert abs((t16 + 1) / 2 ** 16 - (1.0 - rate)) <= 2.0 ** -16
    if rate == 0.5:
        assert t16 == 32767 and (t16 + 1) / 2 ** 16 == 0.5


@pytest.mark.parametrize("rate", [0.5, 0.1, 0.25, 1e-9, 0.999])
def test_carry_compare_is_exact(rate):
    """The kernels' compare (csrc/kernel_prng.cuh, shift_in_drop_*): a half h
    brought to the top 16 bits of a word (shifted, or byte-permuted so the
    other half sits below it) is dropped when adding (0xffff - t16) << 16
    carries out of 32 bits. Exhaustively equal to h > t16 over all 2^16
    halves, the half 0xffff and the rate-0.5 threshold included."""
    t16 = keep_threshold(rate)
    h = np.arange(2 ** 16, dtype=np.uint64)
    for low in (0, 0xABCD, 0xFFFF):  # what sits below the half
        carry = ((h << np.uint64(16)) + np.uint64(low) + np.uint64((0xFFFF - t16) << 16)) \
            >> np.uint64(32)
        np.testing.assert_array_equal(carry.astype(bool), h > t16)
        assert bool(carry[0xFFFF]) and not bool(carry[t16])


def test_halves_of_one_word_are_uncorrelated():
    """On 2^20 elements at rate 0.1: the two halves of a word (columns 2j,
    2j + 1) keep independently, and the kept fraction lies within 5 sigma."""
    mult = keep_mult(SEED, 1024, 1024, 0.1)
    kept = (mult > 0).double()
    keep, n = 1.0 - 0.1, kept.numel()
    p = (keep_threshold(0.1) + 1) / 2 ** 16
    assert abs(kept.mean().item() - p) < 5 * (p * (1 - p) / n) ** 0.5
    even, odd = kept[:, 0::2].flatten().numpy(), kept[:, 1::2].flatten().numpy()
    r = np.corrcoef(even, odd)[0, 1]
    assert abs(r) < 5 / np.sqrt(even.size), r
    # nor the high half of one word and the low half of the next
    r2 = np.corrcoef(kept[:, 1:-1:2].flatten().numpy(), kept[:, 2::2].flatten().numpy())[0, 1]
    assert abs(r2) < 5 / np.sqrt(even.size), r2


def test_streams_are_the_leading_dim():
    m = keep_mult(SEED, 16, 24, 0.25, streams=3)
    for s in range(3):
        want = (bits(SEED, s, range(16), range(24)) <= keep_threshold(0.25)).float() / 0.75
        assert torch.equal(m[s], want)


def test_streams_from_a_first_stream_are_a_slice_of_all():
    """keep_mult(first_stream=f) gives streams f .. f + streams - 1: the
    multiplier of one batch element's heads without the batch's."""
    whole = keep_mult(SEED, 16, 24, 0.25, streams=7)
    assert torch.equal(keep_mult(SEED, 16, 24, 0.25, streams=3, first_stream=4), whole[4:])


def _tile_pairs(n_pairs, rng):
    """Random 64x64 tiles and their neighbours one tile to the right, one tile
    down and one stream on."""
    for _ in range(n_pairs):
        s, r, c = int(rng.integers(0, 1000)), 64 * int(rng.integers(0, 64)), 64 * int(
            rng.integers(0, 64))
        yield (s, r, c), [(s, r, c + 64), (s, r + 64, c), (s + 1, r, c)][int(rng.integers(0, 3))]


def _tile_bits(tiles):
    """dropout_bits of the 64x64 tiles (stream, row0, col0), [len(tiles), 4096]."""
    s, r, c = (torch.tensor(v, dtype=torch.int64) for v in zip(*tiles))
    ar = torch.arange(64, dtype=torch.int64)
    return dropout_bits(SEED, s.view(-1, 1, 1), (r.view(-1, 1) + ar).view(-1, 64, 1),
                        (c.view(-1, 1) + ar).view(-1, 1, 64)).flatten(1)


def test_neighbouring_tiles_are_not_permutations_and_counts_uncorrelated():
    """4000 tile pairs: the correlation of their kept counts has a standard
    error of 1/sqrt(4000) = 0.016, so |r| < 0.05 is a 3-sigma test."""
    rng = np.random.default_rng(0)
    thr = keep_threshold(0.1)
    pairs = list(_tile_pairs(4000, rng))
    counts = []
    for i in range(0, len(pairs), 500):
        a, b = (_tile_bits([p[side] for p in pairs[i:i + 500]]) for side in (0, 1))
        if i == 0:  # no permutation of any kind maps one tile's bits to the other's
            for j in range(50):
                assert not torch.equal(torch.sort(a[j]).values, torch.sort(b[j]).values)
        counts += zip((a <= thr).sum(1).tolist(), (b <= thr).sum(1).tolist())
    r = np.corrcoef(np.asarray(counts, np.float64).T)[0, 1]
    assert abs(r) < 0.05, r


def test_jax_interpret_hash_permutes_neighbouring_blocks():
    """The finding that ruled out the interpret-mode hash: blocks with seeds s
    and s + 1 (neighbouring kv blocks, flash_attention.py:111) have bits that
    are the same values moved by a fixed XOR of the local index, so their
    masks keep exactly the same number of elements."""
    shape = (64, 64)
    for s in (12345, 777, 2 ** 20 + 6):
        a = np.asarray(jax_prng.mask_bits(jnp.int32(s), shape)).ravel()
        b = np.asarray(jax_prng.mask_bits(jnp.int32(s + 1), shape)).ravel()
        k = s ^ (s + 1)
        assert k < a.size
        np.testing.assert_array_equal(b, a[np.arange(a.size) ^ k])
        thr = keep_threshold(0.1)
        assert (a <= thr).sum() == (b <= thr).sum()


def test_draw_seed_is_a_64_bit_host_draw():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    seeds = [draw_seed(g1) for _ in range(4)]
    assert seeds == [draw_seed(g2) for _ in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2 ** 64 for s in seeds)
    assert any(s >= 2 ** 32 for s in seeds)
