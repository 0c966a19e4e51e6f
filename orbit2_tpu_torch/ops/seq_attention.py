"""Sequence-parallel attention over the seq axis (counterpart of
orbit2_tpu/ops/seq_attention.py).

A ResSlimViT whose tokens are split over the seq axis (parallel/tensor.py::
SeqSplit) holds q, k and v as the rank's token slice [B, N/s, H_loc, D]
(H_loc: its heads, all of them or the tensor rank's). Three ways to attend
every query to every key, `SeqSplit.impl` (config `parallelism.seq_impl`):

  * "gather": k and v all-gathered over seq, K1 on the rank's queries
    against all N keys (N_q = N/s, N_k = N); the backward reduce-scatters
    dk/dv, so each slice's gradient sums every rank's part on its home rank.
    Takes attention dropout.
  * "ulysses" (DeepSpeed-Ulysses): an all-to-all swaps the token split for
    a head split, [B, N, H_loc/s, D], K1-K3 run over the full sequence for
    those heads, and a second all-to-all swaps back; the backward's two
    all-to-alls are their transposes. Takes attention dropout; needs H_loc
    divisible by s (JAX's ValueError otherwise).
  * "ring": ops/ring_attention.py, k/v slices passed round the ring. With
    dropout it takes the gather path, as JAX's does.

Dropout: the caller folds the rank's coordinates into the seed
(ops/attention.py, the Attention's `attn_fold`): replica, fsdp and seq, and
tensor where the heads ride it (JAX :166-174, :212-225), so the ranks'
masks differ where their queries or heads do.
"""

from __future__ import annotations

from typing import Optional

from orbit2_tpu_torch.ops.flash_attention import flash_attention
from orbit2_tpu_torch.ops.ring_attention import ring_flash_attention
from orbit2_tpu_torch.parallel.tensor import SeqSplit, all_to_all, gather_seq

SEQ_IMPLS = ("gather", "ring", "ulysses")


def seq_flash_attention(q, k, v, split: SeqSplit, sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed: int = 0):
    """q/k/v: the rank's token slices [B, N/s, H_loc, D] -> o [B, N/s,
    H_loc, D] on the flash kernels (their plain versions on CPU tensors),
    by `split.impl` as the module docstring says (ResSlimViT checks it)."""
    impl = split.impl
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if impl == "ulysses":
        s, h_loc = split.size, q.shape[2]
        if h_loc % s:
            raise ValueError(f"ulysses seq impl needs local heads ({h_loc}) divisible by the "
                             f"seq axis ({s}); use gather/ring instead")
        # [B, N/s, H_loc, D] -> [B, N, H_loc/s, D]: the full sequence, a head subset
        qh, kh, vh = (all_to_all(t, split, 2, 1) for t in (q, k, v))
        o = flash_attention(qh, kh, vh, scale, dropout_rate, seed)
        return all_to_all(o, split, 1, 2)
    if impl == "ring" and dropout_rate == 0.0:
        return ring_flash_attention(q, k, v, split, scale)
    return flash_attention(q, gather_seq(k, split), gather_seq(v, split), scale, dropout_rate,
                           seed)


__all__ = ["SEQ_IMPLS", "seq_flash_attention"]
