"""Dropout bits: the plain PyTorch version of csrc/kernel_prng.cuh.

Counterpart of orbit2_tpu/ops/kernel_prng.py (`mask_bits`, `keep_mult`). One
Philox-4x32-10 call of counter (col // 8, row, stream, 0) under the key
(seed_lo, seed_hi) gives 8 elements 16 bits each: element (row, col) takes
the 16-bit half col % 2 of word (col % 8) // 2. The bits are a pure function
of the seed and an element's GLOBAL coordinates, so a forward and its
backward regenerate the same mask whatever tiles they use. An element is kept
when its half <= keep_threshold(rate) = uint16(keep * (2^16 - 1)), the form of
the JAX package's uint32(keep * (2^32 - 1)); the probability of keeping is
(t16 + 1) / 2^16, within 2^-16 of keep.

The CUDA kernels include csrc/kernel_prng.cuh; this module computes the same
bits with integer torch ops on int64 tensors (32-bit products in 16-bit limbs,
so nothing overflows), on whatever device its arguments live. It is what the
CPU tests use and what the card holds the kernels against.

The JAX package's interpret-mode hash is not ported: it XORs the block seed
into a local index, so blocks whose seeds differ by a small step get masks
that are XOR-permutations of each other (tests/test_torch_kernel_prng.py).
"""

from __future__ import annotations

from typing import Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, b in [0, 2^32)."""
    p_lo = a * (b & 0xFFFF)        # < 2^48
    p_hi = a * (b >> 16)           # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox-4x32-10 on int64 tensors holding uint32 values; returns 4 words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: int, stream: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """16-bit bits (as int64) of every (stream, row, col) the broadcast of the
    three int64 index tensors names."""
    stream, rows, cols = torch.broadcast_tensors(stream, rows, cols)
    words = philox4x32_10(cols >> 3, rows, stream, torch.zeros_like(cols), seed)
    word = (cols & 7) >> 1
    out = words[3]
    for i in (2, 1, 0):
        out = torch.where(word == i, words[i], out)
    return (out >> ((cols & 1) << 4)) & 0xFFFF


def _row_bits(seed: int, stream: torch.Tensor, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """dropout_bits of columns 0 .. cols - 1 of the broadcast (stream, rows),
    one Philox call per 8 columns: [..., cols]."""
    calls = torch.arange((cols + 7) // 8, device=rows.device, dtype=torch.int64)
    stream, rows, calls = torch.broadcast_tensors(stream[..., None], rows[..., None], calls)
    words = torch.stack(philox4x32_10(calls, rows, stream, torch.zeros_like(calls), seed), -1)
    halves = torch.stack((words & 0xFFFF, words >> 16), -1)  # [..., calls, word, half]
    return halves.flatten(-3)[..., :cols]


def keep_threshold(rate: float) -> int:
    """An element is kept when its 16 bits <= this: uint16(keep * (2^16 - 1)),
    the form of orbit2_tpu kernel_prng.py:45 at 16 bits."""
    return int((1.0 - rate) * 65535.0)


def keep_mult(seed: int, rows: int, cols: int, rate: float, streams: Optional[int] = None,
              device=None, first_stream: int = 0) -> torch.Tensor:
    """fp32 multiplier in {0, 1/keep}: [rows, cols] of stream 0, or
    [streams, rows, cols] of streams first_stream .. first_stream + streams
    - 1 (made a few streams at a time, so the int64 intermediates stay
    small)."""
    ar = lambda *bounds: torch.arange(*bounds, device=device, dtype=torch.int64)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    zero = torch.zeros_like(scale)
    threshold = keep_threshold(rate)
    if streams is None:
        bits = _row_bits(seed, ar(1).view(()), ar(rows), cols)
        return torch.where(bits <= threshold, scale, zero)
    out = torch.empty((streams, rows, cols), dtype=torch.float32, device=device)
    chunk = max(1, (1 << 24) // max(1, rows * cols))
    for s0 in range(0, streams, chunk):
        s1 = min(streams, s0 + chunk)
        bits = _row_bits(seed, ar(first_stream + s0, first_stream + s1).view(-1, 1),
                         ar(rows).view(1, -1), cols)
        out[s0:s1] = torch.where(bits <= threshold, scale, zero)
    return out


def draw_seed(generator: torch.Generator) -> int:
    """A 64-bit kernel seed drawn on the host from a CPU generator: no device sync."""
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=generator, dtype=torch.int64).tolist()
    return lo | (hi << 32)


_M64 = (1 << 64) - 1


def fold_seed(seed: int, coords=()) -> int:
    """`seed` with each of `coords` folded in (splitmix64 of the seed offset
    by the coordinate): the mesh path's counterpart of jax.random.fold_in,
    so ranks that hold different data, or different heads or columns, draw
    different masks. No coordinate: the seed itself."""
    for c in coords:
        z = (seed + 0x9E3779B97F4A7C15 * (int(c) + 1)) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        seed = z ^ (z >> 31)
    return seed


__all__ = ["philox4x32_10", "dropout_bits", "keep_threshold", "keep_mult", "draw_seed",
           "fold_seed"]
