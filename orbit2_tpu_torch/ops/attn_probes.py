"""Attention probes: four CUDA kernels that strip the flash forward one part
at a time, their wrappers and their plain versions.

Counterpart of the Pallas probes of scripts/bench_attn2.py, in its layout:
q, k, v [BH, N, 64] bf16, o [BH, N, 64] bf16, fp32 sums, scores unscaled
except in the bound shift.

- `matmul_only`: o = bf16(q k^T) v
- `exp_noreduce`: o = bf16(exp2(q k^T - 20)) v
- `full_softmax`: o = (bf16(p) v) / rowsum(p), p = exp2(s - rowmax(s))
- `bound_shift`: o = (bf16(p) v) / rowsum(bf16(p)), p = exp2(qs k^T - b), on
  the (qs, b) of `bound_shift_inputs`

The kernels (csrc/attn_probes.cu) are variants of the flash forward's bf16
kernel (csrc/flash_fwd_hopper.cuh) that change only what happens to the
scores between its two products, so their times decompose the forward's. Each
plain version rounds where the kernel rounds: s or p to bf16 before the value
product, o once at the end. On CPU tensors a wrapper computes its plain
version; on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orbit2_tpu_torch.ops._nvcc import NvccKernel, NvccLibrary
from orbit2_tpu_torch.ops.flash_attention import tma_operands

LOG2E = 1.4426950408889634
HEAD_DIM = 64
BLOCK = 64  # the JAX probes' query block: N must be a multiple of it
EXP_SHIFT = 20.0  # scripts/bench_attn2.py:59

LIBRARY = NvccLibrary("attn_probes.cu")


class ProbeKernel(NvccKernel):
    """One entry point of csrc/attn_probes.cu: o of (q, k, v[, bound])."""

    def __init__(self, symbol: str, with_bound: bool = False):
        self.with_bound = with_bound
        super().__init__(LIBRARY, symbol, [ctypes.c_void_p] * (6 if with_bound else 5)
                         + [ctypes.c_int64, ctypes.c_int64])

    def __call__(self, q, k, v, bound=None):
        if (bound is None) == self.with_bound:
            raise ValueError(f"{self.name} takes {'a' if self.with_bound else 'no'} bound")
        if _check(q, k, v, bound) != "cuda":
            raise ValueError(f"{self.name}: q, k, v must be CUDA tensors")
        # the kernel reads q, k and v by TMA as K1's [B = BH, N, H = 1, 64]
        q, k, v, strides = tma_operands(q[:, :, None], k[:, :, None], v[:, :, None])
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
        if self.with_bound:
            bound = bound.contiguous()
            ptrs.append(bound.data_ptr())
        bh, n = q.shape[:2]
        o = torch.empty((bh, n, HEAD_DIM), dtype=q.dtype, device=q.device)
        self.launch(q.device, *ptrs, o.data_ptr(), strides, bh, n)
        return o


PROBE_MATMUL_ONLY = ProbeKernel("orbit2_probe_matmul_only")
PROBE_EXP_NOREDUCE = ProbeKernel("orbit2_probe_exp_noreduce")
PROBE_FULL_SOFTMAX = ProbeKernel("orbit2_probe_full_softmax")
PROBE_BOUND_SHIFT = ProbeKernel("orbit2_probe_bound_shift", with_bound=True)


def _check(q, k, v, bound=None) -> str:
    """The device type of the inputs, after checking what the kernels take:
    bf16 [BH, N, 64] of one shape, N a positive multiple of 64, bound fp32
    [BH, N]."""
    ts = (q, k, v) if bound is None else (q, k, v, bound)
    devices = {t.device.type for t in ts}
    if devices not in ({"cpu"}, {"cuda"}) or len({t.device for t in ts}) != 1:
        raise ValueError(f"attention probes need all tensors on one cpu or cuda device, got "
                         f"{[t.device for t in ts]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"attention probes take bfloat16 q, k, v, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention probes take q, k, v of one shape [BH, N, D], got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    bh, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention probes take head dim {HEAD_DIM}, got {d}")
    if n < BLOCK or n % BLOCK:
        raise ValueError(f"attention probes need N a positive multiple of {BLOCK}, got {n}")
    if not 1 <= bh <= 65535:
        raise ValueError(f"attention probes need 1 <= BH <= 65535, got {bh}")
    if bound is not None and (bound.dtype != torch.float32 or tuple(bound.shape) != (bh, n)):
        raise ValueError(f"bound must be fp32 [{bh}, {n}], got {bound.dtype} "
                         f"{tuple(bound.shape)}")
    return devices.pop()


# ---- plain versions ------------------------------------------------------------

def _scores(q, k) -> torch.Tensor:
    """q k^T [BH, N, N] in fp32."""
    return torch.bmm(q.float(), k.float().transpose(1, 2))


def _value_product(p, v) -> torch.Tensor:
    """bf16(p) v in fp32."""
    return torch.bmm(p.to(torch.bfloat16).float(), v.float())


def matmul_only_reference(q, k, v) -> torch.Tensor:
    return _value_product(_scores(q, k), v).to(torch.bfloat16)


def exp_noreduce_reference(q, k, v) -> torch.Tensor:
    return _value_product(torch.exp2(_scores(q, k) - EXP_SHIFT), v).to(torch.bfloat16)


def full_softmax_reference(q, k, v) -> torch.Tensor:
    s = _scores(q, k)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return (_value_product(p, v) / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def bound_shift_reference(qs, k, v, bound) -> torch.Tensor:
    p = torch.exp2(_scores(qs, k) - bound.unsqueeze(-1)).to(torch.bfloat16).float()
    return (torch.bmm(p, v.float()) / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def bound_shift_inputs(q, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qs, bound) of `run_bound`'s preparation (scripts/bench_attn2.py:112-118)
    without the padding to 128 lanes: qs = bf16(q D^-1/2 log2 e) and bound =
    |qs_i| max_j |k_j|, fp32 [BH, N]. By Cauchy-Schwarz bound_i >= qs_i . k_j,
    so exp2(s - bound) never exceeds 1."""
    qs = (q.float() * (q.shape[-1] ** -0.5 * LOG2E)).to(torch.bfloat16)
    qn = torch.linalg.vector_norm(qs.float(), dim=-1)
    kn = torch.linalg.vector_norm(k.float(), dim=-1).amax(dim=-1)
    return qs, qn * kn.unsqueeze(-1)


def softmax_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T D^-1/2) v in fp32, what the bound shift computes on
    bound_shift_inputs(q, k)."""
    s = _scores(q, k) * q.shape[-1] ** -0.5
    return torch.bmm(torch.softmax(s, dim=-1), v.float())


# ---- wrappers ------------------------------------------------------------------

def _run(kernel: ProbeKernel, plain, *args) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA ones."""
    return plain(*args) if _check(*args) == "cpu" else kernel(*args)


def matmul_only(q, k, v) -> torch.Tensor:
    return _run(PROBE_MATMUL_ONLY, matmul_only_reference, q, k, v)


def exp_noreduce(q, k, v) -> torch.Tensor:
    return _run(PROBE_EXP_NOREDUCE, exp_noreduce_reference, q, k, v)


def full_softmax(q, k, v) -> torch.Tensor:
    return _run(PROBE_FULL_SOFTMAX, full_softmax_reference, q, k, v)


def bound_shift(qs, k, v, bound) -> torch.Tensor:
    return _run(PROBE_BOUND_SHIFT, bound_shift_reference, qs, k, v, bound)


def probe_flops(bh: int, n: int, d: int = HEAD_DIM) -> int:
    """Useful flops of a probe: its two products, 4 BH N^2 D
    (scripts/bench_attn2.py:24); the two-sweep full softmax does 1.5x."""
    return 4 * bh * n * n * d


__all__ = ["PROBE_MATMUL_ONLY", "PROBE_EXP_NOREDUCE", "PROBE_FULL_SOFTMAX", "PROBE_BOUND_SHIFT",
           "matmul_only", "exp_noreduce", "full_softmax", "bound_shift", "bound_shift_inputs",
           "matmul_only_reference", "exp_noreduce_reference", "full_softmax_reference",
           "bound_shift_reference", "softmax_attention", "probe_flops", "HEAD_DIM", "BLOCK"]
