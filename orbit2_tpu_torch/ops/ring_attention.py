"""Ring attention over the seq axis (counterpart of
orbit2_tpu/ops/ring_attention.py).

q, k and v are the rank's token slices [B, N/s, H, D]. The k/v slices go
round the ring of the s seq ranks (`parallel/tensor.py::ring_shift`), so no
rank holds more than its own and the one in flight:

  * forward: at each of the s steps K1 (`flash_attention_fwd`) attends the
    rank's queries to the resident k/v slice and returns that slice's
    (o_j, lse_j); the partial results merge in fp32 by base-2 running max,
    numerator and denominator (JAX :73-99), as exact as one softmax over
    all N keys. The merge is plain torch, as JAX's is XLA outside any
    kernel;
  * backward: the flash-attention-2 decomposition against the GLOBAL o and
    lse: at each step K2 and K3 (`flash_attention_bwd`, delta computed
    once) give dq_j and the resident slice's dk_j, dv_j; dq accumulates on
    the rank, and the fp32 dk/dv accumulators rotate with their slice, so
    after s steps each is home holding every rank's part (JAX :107-135).

Attention-probability dropout is not taken here: its masks would need the
keys' global positions across steps. ops/seq_attention.py sends ring with
dropout to the gather path, as JAX's does. As in JAX, N/s must be a
multiple of 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from orbit2_tpu_torch.ops.flash_attention import (
    attention_delta, flash_attention_bwd, flash_attention_fwd)
from orbit2_tpu_torch.parallel.tensor import SeqSplit, ring_shift


def _per_row(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """A [B*H, N] row statistic as a [B, N, H, 1] multiplier of o."""
    return t.view(b, h, -1).permute(0, 2, 1).unsqueeze(-1)


def _shift(split: SeqSplit, *tensors: torch.Tensor):
    """Each of `tensors` handed to the next rank of the ring, in one
    collective (stacked: they share a shape and dtype)."""
    moved = ring_shift(torch.stack(tensors), split.group, split.size, split.rank)
    return moved.unbind(0)


class RingAttention(torch.autograd.Function):
    """o = softmax(q k^T scale) v over the keys of every seq rank."""

    @staticmethod
    def forward(ctx, q, k, v, split: SeqSplit, sm_scale: float):
        b, n, h, d = q.shape
        m = torch.full((b * h, n), float("-inf"), dtype=torch.float32, device=q.device)
        den = torch.zeros((b * h, n), dtype=torch.float32, device=q.device)
        num = torch.zeros((b, n, h, d), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for step in range(split.size):
            o_j, lse_j = flash_attention_fwd(q, k_cur, v_cur, sm_scale)
            if step + 1 < split.size:
                k_cur, v_cur = _shift(split, k_cur, v_cur)
            m_new = torch.maximum(m, lse_j)
            c_old, c_new = torch.exp2(m - m_new), torch.exp2(lse_j - m_new)
            num = num * _per_row(c_old, b, h) + o_j.float() * _per_row(c_new, b, h)
            den = den * c_old + c_new
            m = m_new
        o = (num / _per_row(den, b, h)).to(q.dtype)
        lse = (m + torch.log2(den)).contiguous()  # the global base-2 lse
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.split, ctx.sm_scale = split, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        split = ctx.split
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for step in range(split.size):
            dq_j, dk_j, dv_j = flash_attention_bwd(q, k_cur, v_cur, o, lse, do, ctx.sm_scale,
                                                   delta=delta)
            dq += dq_j.float()
            dk += dk_j.float()
            dv += dv_j.float()
            if step + 1 < split.size:
                k_cur, v_cur = _shift(split, k_cur, v_cur)
            # the accumulators travel with their slice: after s shifts, home
            dk, dv = _shift(split, dk, dv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q, k, v, split: SeqSplit, sm_scale: Optional[float] = None):
    """q/k/v: the rank's token slices [B, N/s, H, D] -> o [B, N/s, H, D]."""
    n_local = q.shape[1]
    if n_local % 128:
        raise ValueError(f"ring attention needs N_local % 128 == 0, got {n_local}")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return RingAttention.apply(q, k, v, split, float(scale))


__all__ = ["RingAttention", "ring_flash_attention"]
