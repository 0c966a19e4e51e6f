"""Attention implementation dispatch (counterpart of orbit2_tpu/ops/attention.py).

  * "auto" / "pallas" — flash attention (ops/flash_attention.py): the
    hand-written CUDA kernels for bf16 or fp32 CUDA tensors (any N >= 1;
    ragged tails are masked in the kernel), their plain versions for CPU
    tensors; attention-probability dropout runs inside the kernels. Shapes
    the kernels do not take (`flash_supported`: a head dim outside
    HEAD_DIMS, another dtype, B*H past the grid) go to the "xla" path on
    every device, as the JAX dispatcher falls back to XLA.
  * "xla" / "naive"   — plain softmax attention, the JAX `_sdpa` math:
    probabilities in fp32, cast to the input dtype, dropped, then the value
    product.

Both take the dropout seed from `generator` and draw the same Philox mask
(ops/kernel_prng.py at (seed, batch*head, query, key)), so at equal seeds the
two paths drop the same probabilities. All functions take q, k, v as
[B, N, H, Dh] ("BNHD") and return [B, N, H, Dh].
"""

from __future__ import annotations

from typing import Optional

import torch

from orbit2_tpu_torch.ops.flash_attention import (
    attention_mult, flash_attention, flash_supported)
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, fold_seed


def _sdpa(q, k, v, scale: float, dropout_rate: float = 0.0, seed: int = 0):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    mult = attention_mult(q, k, dropout_rate, seed)
    if mult is not None:
        probs = (probs.float() * mult.view(probs.shape)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, impl: str = "xla", scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None, fold=()):
    """q: [B, Nq, H, Dh]; k/v: [B, Nk, H, Dh]. dropout_rate > 0 needs `generator`;
    the mesh coordinates `fold` are folded into its seed (on a mesh, q, k and
    v are the rank's local batch and heads: batch_flash_attention's fold of
    the replica, fsdp and tensor indices, JAX seq_attention.py:88-93)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    seed = 0
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        seed = fold_seed(draw_seed(generator), fold)
    if impl in ("auto", "pallas"):
        if flash_supported(q, k, v):
            return flash_attention(q, k, v, sm_scale=scale, dropout_rate=dropout_rate, seed=seed)
        impl = "xla"
    if impl in ("xla", "naive"):
        return _sdpa(q, k, v, scale, dropout_rate, seed)
    raise ValueError(f"unknown attention impl {impl!r}")
