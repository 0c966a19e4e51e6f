"""Dropout bits: the plain PyTorch version of csrc/kernel_prng.cuh.

Counterpart of orbit2_tpu/ops/kernel_prng.py (`mask_bits`, `keep_mult`). The
bits are Philox-4x32-10 of (col // 4, row, stream, 0) under the key
(seed_lo, seed_hi): a pure function of the seed and an element's GLOBAL
coordinates, so a forward and its backward regenerate the same mask whatever
tiles they use. The CUDA kernels include csrc/kernel_prng.cuh; this module
computes the same bits with integer torch ops on int64 tensors (32-bit
products in 16-bit limbs, so nothing overflows), on whatever device its
arguments live. It is what the CPU tests use and what the card holds the
kernels against.

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
    """uint32 bits (as int64) of every (stream, row, col) the broadcast of the
    three int64 index tensors names."""
    stream, rows, cols = torch.broadcast_tensors(stream, rows, cols)
    words = philox4x32_10(cols >> 2, rows, stream, torch.zeros_like(cols), seed)
    lane = cols & 3
    out = words[3]
    for i in (2, 1, 0):
        out = torch.where(lane == i, words[i], out)
    return out


def keep_threshold(rate: float) -> int:
    """An element is kept when its bits <= this (orbit2_tpu kernel_prng.py:45)."""
    return int((1.0 - rate) * 4294967295.0)


def keep_mult(seed: int, rows: int, cols: int, rate: float, streams: Optional[int] = None,
              device=None) -> torch.Tensor:
    """fp32 multiplier in {0, 1/keep}: [rows, cols] of stream 0, or
    [streams, rows, cols] of streams 0 .. streams - 1 (made a few streams at
    a time, so the int64 intermediates stay small)."""
    ar = lambda *bounds: torch.arange(*bounds, device=device, dtype=torch.int64)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    zero = torch.zeros_like(scale)
    row_ids, col_ids = ar(rows).view(-1, 1), ar(cols).view(1, -1)
    if streams is None:
        bits = dropout_bits(seed, ar(1).view(()), row_ids, col_ids)
        return torch.where(bits <= keep_threshold(rate), scale, zero)
    out = torch.empty((streams, rows, cols), dtype=torch.float32, device=device)
    chunk = max(1, (1 << 24) // max(1, rows * cols))
    for s0 in range(0, streams, chunk):
        s1 = min(streams, s0 + chunk)
        bits = dropout_bits(seed, ar(s0, s1).view(-1, 1, 1), row_ids, col_ids)
        out[s0:s1] = torch.where(bits <= keep_threshold(rate), scale, zero)
    return out


def draw_seed(generator: torch.Generator) -> int:
    """A 64-bit kernel seed drawn on the host from a CPU generator: no device sync."""
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=generator, dtype=torch.int64).tolist()
    return lo | (hi << 32)


__all__ = ["philox4x32_10", "dropout_bits", "keep_threshold", "keep_mult", "draw_seed"]
