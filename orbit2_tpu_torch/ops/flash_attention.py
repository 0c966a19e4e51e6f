"""Flash-attention forward: the CUDA kernel, its wrapper and its plain version.

Counterpart of orbit2_tpu/ops/flash_attention.py (forward only; the backward
kernels and in-kernel dropout come with training). Public layout is the JAX
package's: q [B, N_q, H, D], k/v [B, N_k, H, D]. The forward returns
(o [B, N_q, H, D] in q's dtype, lse fp32 [B*H, N_q]) where lse is the base-2
logsumexp of the scaled scores, the residual the backward kernels and ring
attention consume.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel in csrc/flash_attn_fwd.cu or raises. There is no
fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from orbit2_tpu_torch.ops._nvcc import NvccLibrary

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FlashForwardKernel:
    """The nvcc-built forward kernel and the count of its launches."""

    def __init__(self):
        self.library = NvccLibrary("flash_attn_fwd.cu")
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = self.library.load()
            fn = lib.orbit2_flash_attn_fwd
            fn.argtypes = [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [
                ctypes.c_int64] * 4 + [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.orbit2_cuda_error_string.argtypes = [ctypes.c_int]
            lib.orbit2_cuda_error_string.restype = ctypes.c_char_p
            self._errstr = lib.orbit2_cuda_error_string
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, sm_scale: float):
        _check_cuda_inputs(q, k, v)
        b, n_q, h, d = q.shape
        n_k = k.shape[1]
        fn = self._entry()
        o = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, n_q), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        # every row 16-byte aligned: the bf16 tiles load 8 elements at a time
        vec = all(t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
                  for t in (q, k, v))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), b, h, n_q, n_k, strides,
                     float(sm_scale), int(vec), stream)
        if err != 0:
            msg = ("no kernel instance" if err < 0
                   else self._errstr(err).decode())
            raise RuntimeError(f"flash_attn_fwd launch failed ({err}): {msg}")
        self.launches += 1
        return o, lse


FLASH_FWD = FlashForwardKernel()


def _check_cuda_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attn_fwd: q, k and v must all be CUDA tensors")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attn_fwd: q, k and v are on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attn_fwd takes bfloat16 or float32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, n_q, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on B, H or D")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd supports head dims {HEAD_DIMS}, got {d}")
    if n_q < 1 or k.shape[1] < 1:
        raise ValueError("flash_attn_fwd needs N_q >= 1 and N_k >= 1")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535 limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attn_fwd: {name} must be contiguous in its last dim")


def flash_attention_reference(q, k, v, sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward in fp32 math: (o in q.dtype, base-2 lse fp32 [B*H, N_q])."""
    b, n_q, h, d = q.shape
    scale = d ** -0.5 if sm_scale is None else sm_scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log2(l)).reshape(b * h, n_q)
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v, scale)
    if devices == {"cuda"}:
        return FLASH_FWD(q, k, v, scale)
    raise ValueError(f"flash attention needs q/k/v on one of cpu or cuda, got {devices}")


def flash_attention(q, k, v, sm_scale: Optional[float] = None, dropout_rate: float = 0.0):
    """q/k/v: [B, N, H, D] -> o [B, N_q, H, D] (the JAX package's public signature)."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet: it comes with the training kernels")
    return flash_attention_fwd(q, k, v, sm_scale)[0]


def attention_flops(b: int, n_q: int, n_k: int, h: int, d: int) -> int:
    """Flops of the two products of one forward (the JAX CostEstimate's count)."""
    return 4 * b * h * n_q * n_k * d


__all__ = ["FLASH_FWD", "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "attention_flops", "LOG2E", "HEAD_DIMS"]
