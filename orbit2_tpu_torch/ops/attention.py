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

Where the tokens are split over a seq axis (`seq`, a parallel/tensor.py::
SeqSplit of more than one rank) q, k and v are the rank's token slices and
the call goes to ops/seq_attention.py (JAX's dispatch to
seq_flash_attention): the seq impl on the flash kernels, or, on the "xla"
path, k and v gathered and the plain softmax over all of them (what JAX's
GSPMD makes of its plain attention under a seq mesh).
"""

from __future__ import annotations

from typing import Optional

import torch

from orbit2_tpu_torch.ops.flash_attention import (
    attention_mult, flash_attention, flash_supported)
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, fold_seed
from orbit2_tpu_torch.ops.seq_attention import seq_flash_attention
from orbit2_tpu_torch.parallel.tensor import SeqSplit, gather_seq


def _sdpa(q, k, v, scale: float, dropout_rate: float = 0.0, seed: int = 0):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    mult = attention_mult(q, k, dropout_rate, seed)
    if mult is not None:
        probs = (probs.float() * mult.view(probs.shape)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, impl: str = "xla", scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None, fold=(),
                          seq: Optional[SeqSplit] = None):
    """q: [B, Nq, H, Dh]; k/v: [B, Nk, H, Dh]. dropout_rate > 0 needs `generator`;
    the mesh coordinates `fold` are folded into its seed (on a mesh, q, k and
    v are the rank's local batch, heads and tokens: the fold of the replica,
    fsdp, seq and tensor indices, JAX seq_attention.py:88-93, :166-174).
    `seq`: the seq axis the tokens are split over (module docstring)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    seed = 0
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        seed = fold_seed(draw_seed(generator), fold)
    if impl not in ("auto", "pallas", "xla", "naive"):
        raise ValueError(f"unknown attention impl {impl!r}")
    flash = impl in ("auto", "pallas") and flash_supported(q, k, v)
    split = seq is not None and seq.size > 1
    if flash:
        if split:
            return seq_flash_attention(q, k, v, seq, scale, dropout_rate, seed)
        return flash_attention(q, k, v, sm_scale=scale, dropout_rate=dropout_rate, seed=seed)
    if split:
        k, v = gather_seq(k, seq), gather_seq(v, seq)
    return _sdpa(q, k, v, scale, dropout_rate, seed)
