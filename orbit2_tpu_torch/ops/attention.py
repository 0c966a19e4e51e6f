"""Attention implementation dispatch (counterpart of orbit2_tpu/ops/attention.py).

  * "auto" / "pallas" — the flash-attention forward (ops/flash_attention.py):
    the hand-written CUDA kernel for bf16 or fp32 CUDA tensors (any N >= 1;
    ragged tails are masked in the kernel), its plain version for CPU tensors.
  * "xla" / "naive"   — plain softmax attention, the JAX `_sdpa` math:
    probabilities in fp32, cast to the input dtype before the value product.

All functions take q, k, v as [B, N, H, Dh] ("BNHD") and return [B, N, H, Dh].
Attention dropout is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from orbit2_tpu_torch.ops.flash_attention import flash_attention

def _sdpa(q, k, v, scale: float):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, impl: str = "xla", scale: Optional[float] = None,
                          dropout_rate: float = 0.0):
    """q: [B, Nq, H, Dh]; k/v: [B, Nk, H, Dh]."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet: it comes with the training kernels")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if impl in ("auto", "pallas"):
        return flash_attention(q, k, v, sm_scale=scale)
    if impl in ("xla", "naive"):
        return _sdpa(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r}")
